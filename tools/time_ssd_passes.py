"""Time the Mamba2 scan (B6) on the card, whole and pass by pass.

    python3 tools/time_ssd_passes.py [--shapes 4x4096,1x32768] [--reps 20]

At zamba2's widths (H = 80, P = N = 64, bf16 unless ``--dtype float32``)
and each (B, T) of ``--shapes``: the wrapper's device time per call (CUDA
events around ``--reps`` calls queued behind a sleep kernel) and, from one
profiled window of ``--reps`` calls, the device time of each CUDA kernel a
call launches (chunk state, state pass, chunk scan), with the bytes each
pass must move at least and the rate that gives.  Inputs are drawn on the
card from a seed.  One JSON object per line; the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def inputs(B, T, H, P, N, dtype, dev, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    xh = (0.5 * torch.randn((B, T, H, P), generator=g, device=dev)).to(dtype)
    a = torch.rand((B, T, H), generator=g, device=dev) * 0.1 + 0.9
    b = (0.3 * torch.randn((B, T, N), generator=g, device=dev)).to(dtype)
    c = (0.3 * torch.randn((B, T, N), generator=g, device=dev)).to(dtype)
    return xh, a, b, c


def pass_bytes(B, T, H, P, N, esize, chunk):
    """Least bytes each pass moves: x (and a) read, the chunk states
    written (pass 1), read and written (pass 2), read with x and y written
    (pass 3); B and C once per chunk."""
    nc = -(-T // chunk)
    x, y = B * T * H * P * esize, B * T * H * P * esize
    a, bc = B * T * H * 4, B * T * N * esize
    states = B * nc * H * (P * N + 1) * 4
    return {"chunk_state": x + a + bc + states,
            "state_pass": 2 * states,
            "chunk_scan": x + a + 2 * bc + states + y}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="4x4096,1x32768")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import mamba2_scan as m2

    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    chunk = m2.library(dev)[0].mamba2_scan_chunk(int(dtype == torch.bfloat16))
    print(json.dumps({"gpu": cs.nvidia_smi_line(), "dtype": args.dtype,
                      "chunk": chunk}), flush=True)
    H, P, N = 80, 64, 64
    for shape in args.shapes.split(","):
        B, T = (int(v) for v in shape.split("x"))
        xh, a, b, c = inputs(B, T, H, P, N, dtype, dev)

        def call():
            return m2.mamba2_scan_kernel(xh, a, b, c)
        device_ms, host_ms = cs._queued_ms(call, args.reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        need = pass_bytes(B, T, H, P, N, xh.element_size(), chunk)
        passes = {}
        for ev in prof.key_averages():
            name = ev.key
            for p in need:
                if p in name:
                    ms = (getattr(ev, "self_device_time_total", 0.0)
                          or 0.0) / 1e3 / args.reps
                    passes[p] = {"ms": ms, "bytes": need[p],
                                 "tb_per_s": need[p] / (ms * 1e-3) / 1e12
                                 if ms else None}
        print(json.dumps({"B": B, "T": T, "H": H, "P": P, "N": N,
                          "device_ms": device_ms, "host_ms": host_ms,
                          "passes": passes,
                          "bytes": sum(need.values()),
                          "bound_ms": sum(need.values())
                          / cs.HBM_BYTES_PER_S * 1e3}), flush=True)
        del xh, a, b, c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
