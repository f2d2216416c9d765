"""Time flash attention's f32 arm (B5) on the card beside SDPA.

    python3 tools/time_attention_f32.py [--src DIR] [--reps 20]
                                        [--dtype bfloat16] [--wide]

At the training path's shape (qwen2_1_5b: 2 x 1,024 tokens, 12 query / 2
KV heads of 128, causal) and at the model stack's prefill geometries in
f32 (qwen2 4 x 4,096; zamba2's shared block at dh 160; gemma3's dh 256
with a window of 1,024 and without; seamless's non-causal encoder at dh 64): the
kernel's device time per call (``--reps`` calls queued behind a sleep
kernel, CUDA events) beside ``scaled_dot_product_attention``'s on the same
input (KV expanded, the window as a mask), the bound at the 3xTF32 rate
(495 / 3 TFLOP/s) and at FFMA's (67), the TFLOP/s of the bound's
operations and the kernel's largest difference from the plain version.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two trees compare in one call.
``--dtype bfloat16`` times the bf16 arm at the same shapes instead (its
bound at the bf16 tensor-core rate); ``--wide`` adds the widths past the
kernels' own (dh 12 and 100, padded; 264, 320 and 512, the f32 kernel's
output in slices, bf16 upcast to it), which a parent tree refuses (that
row then names the refusal).
Inputs are drawn on the card from a seed.  One JSON object per line; the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (label, B, T, H, Hk, dh, causal, window)
SHAPES = (("train qwen2 2x1024", 2, 1024, 12, 2, 128, True, None),
          ("qwen2 4x4096", 4, 4096, 12, 2, 128, True, None),
          ("zamba2 shared 4x4096 dh160", 4, 4096, 32, 32, 160, True, None),
          ("gemma3 local 1x4096 dh256", 1, 4096, 16, 8, 256, True, 1024),
          ("gemma3 global 1x4096 dh256", 1, 4096, 16, 8, 256, True, None),
          ("seamless encoder 4x4096 dh64", 4, 4096, 16, 16, 64, False,
           None))
#: --wide: the widths past the kernels' own, causal prefill
WIDE = (("dh12 4x4096", 4, 4096, 16, 16, 12, True, None),
        ("dh100 4x4096", 4, 4096, 16, 16, 100, True, None),
        ("dh264 1x4096", 1, 4096, 8, 8, 264, True, None),
        ("dh320 1x4096", 1, 4096, 8, 8, 320, True, None),
        ("dh512 1x4096", 1, 4096, 8, 8, 512, True, None))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--wide", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # puts this checkout's src on the path
    sys.path.insert(0, os.path.abspath(args.src))   # --src ahead of it

    import torch
    from repro_torch.kernels import accounting, ops, ref

    if not torch.cuda.is_available():
        print("time_attention_f32: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"gpu": cs.nvidia_smi_line(),
                      "src": os.path.abspath(args.src),
                      "dtype": args.dtype}), flush=True)
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    for label, B, T, H, Hk, dh, causal, window in SHAPES + (
            WIDE if args.wide else ()):
        g = torch.Generator(device=dev).manual_seed(0)
        q = (0.5 * torch.randn(B, T, H, dh, generator=g, device=dev)).to(dt)
        k, v = ((0.5 * torch.randn(B, T, Hk, dh, generator=g, device=dev)
                 ).to(dt) for _ in range(2))
        static = {"causal": causal, "window": window}
        row = {"shape": label, "inputs": [B, T, H, Hk, dh], **static}

        def call():
            return ops.flash_attention(q, k, v, **static)
        try:
            got = call()
        except ValueError as e:          # a tree that refuses the width
            print(json.dumps({**row, "refused": str(e)}), flush=True)
            continue
        want = ref.flash_attention_ref(q, k, v, **static)
        err = float((got.float() - want.float()).abs().max())
        del got, want
        sdpa = cs._sdpa_call(q, k, v, static)
        dev_ms = cs._queued_ms(call, args.reps)[0]
        sdpa_ms = cs._queued_ms(sdpa, args.reps)[0]
        flops = accounting.work("flash_attention", [q, k, v], static)[0]
        bound = cs._model_bound_ms("flash_attention", [q, k, v], static)[0]
        print(json.dumps({
            **row, "device_ms": dev_ms, "sdpa_device_ms": sdpa_ms,
            "vs_sdpa": dev_ms / sdpa_ms, "tflops": flops / dev_ms / 1e9,
            "bound_ms": bound, "bound_share": bound / dev_ms,
            "bound_ms_ffma": flops / cs.FP32_OPS_PER_S * 1e3,
            "max_abs_err": err}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
