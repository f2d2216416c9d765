"""Time the chunkwise mLSTM (B7) on the card, whole and launch by launch.

    python3 tools/time_mlstm_passes.py [--shapes 4x4096] [--reps 20]

At xLSTM-350M's widths (H = 4, K = P = 512, bf16 unless ``--dtype
float32``) and each (B, T) of ``--shapes``: the wrapper's device time per
call (CUDA events around ``--reps`` calls queued behind a sleep kernel)
and, from one profiled window of ``--reps`` calls, the device time of each
CUDA kernel a call launches (the scores, the recurrence; one FFMA kernel in
f32), with the bytes each must move at least, the tensor-core products it
issues (the hi + lo pairs counted twice) and the rates those give.  Inputs
are drawn on the card from a seed, the gates over the model's range
(sigmoid forget gates, input gates exp(U(-10, 10))).  One JSON object per
line; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def inputs(B, T, H, K, P, dtype, dev, seed=0):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, T, H, K), generator=g, device=dev).to(dtype)
    k = (0.3 * torch.randn((B, T, H, K), generator=g, device=dev)).to(dtype)
    v = torch.randn((B, T, H, P), generator=g, device=dev).to(dtype)
    a = torch.sigmoid(2.0 * torch.randn((B, T, H), generator=g, device=dev))
    i = torch.exp(20.0 * torch.rand((B, T, H), generator=g, device=dev)
                  - 10.0)
    return q, k, v, a, i


def pass_work(B, T, H, K, P, esize, chunk, record, p_slice):
    """Per launch of the bf16 path, the least bytes it moves (each input
    read once, each output written once) and the flops of the products it
    issues: the scores read q, k and the gates and write the records; the
    recurrence reads q, k, v and the records and writes y.  The causal
    16 x 16 tiles of a chunk: kQ / 16 (kQ / 16 + 1) / 2."""
    nc = -(-T // chunk)
    rt = chunk // 16
    tiles = rt * (rt + 1) // 2
    qk, vy = B * T * H * K * esize, B * T * H * P * esize
    gates, records = 2 * B * T * H * 4, B * nc * H * record
    per_chunk = B * nc * H
    slices = -(-P // p_slice)
    return {
        "mlstm_scores": {
            "bytes": 2 * qk + gates + records,
            "flops": per_chunk * tiles * 2 * 256 * K},
        "mlstm_recur": {
            "bytes": 2 * qk + records + 2 * vy,
            # q C_{c-1} and the C update with C and K o dte as pairs, W V
            # with W as a pair, over every P slice of the padded width
            "flops": 2 * (2 * 2 * B * T * H * K * p_slice * slices)
            + per_chunk * tiles * 2 * 2 * 256 * p_slice * slices},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="4x4096")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import mlstm

    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    lib, max_dyn = mlstm.library(dev)
    H, K, P = 4, 512, 512
    p_slice = next(pt for pt in mlstm.P_SLICES
                   if 0 <= lib.mlstm_smem_bytes(1, K, pt) <= max_dyn)
    print(json.dumps({"gpu": cs.nvidia_smi_line(), "dtype": args.dtype,
                      "chunk": lib.mlstm_chunk(), "p_slice": p_slice,
                      "record_bytes": lib.mlstm_record_bytes()}), flush=True)
    for shape in args.shapes.split(","):
        B, T = (int(v) for v in shape.split("x"))
        q, k, v, a, i = inputs(B, T, H, K, P, dtype, dev)

        def call():
            return mlstm.mlstm_chunked_kernel(q, k, v, a, i)
        device_ms, host_ms = cs._queued_ms(call, args.reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                call()
            torch.cuda.synchronize()
        need = pass_work(B, T, H, K, P, q.element_size(), lib.mlstm_chunk(),
                         lib.mlstm_record_bytes(), p_slice)
        passes = {}
        for ev in prof.key_averages():
            ms = (getattr(ev, "self_device_time_total", 0.0) or 0.0) \
                / 1e3 / args.reps
            if not ms or "mlstm" not in ev.key:
                continue
            name = next((p for p in need if p in ev.key), ev.key)
            row = {"ms": ms, "launches_per_call": ev.count / args.reps}
            if name in need:
                row.update(need[name])
                row["tb_per_s"] = need[name]["bytes"] / (ms * 1e-3) / 1e12
                row["tflop_per_s"] = need[name]["flops"] / (ms * 1e-3) / 1e12
            passes[name] = row
        print(json.dumps({"B": B, "T": T, "H": H, "K": K, "P": P,
                          "device_ms": device_ms, "host_ms": host_ms,
                          "passes": passes}), flush=True)
        del q, k, v, a, i
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
