"""Reproducer of the compiler fault that ``fifo_grant``'s workaround avoids.

    python3 tools/fifo_grant_fold.py [--lanes 64]

``select_head`` (``csrc/pbm_timeline.cu``) tests ``m >= n_part`` itself,
on its argument as passed, because the same test written in
``fifo_grant_kernel`` as ``lim == n_part`` once read true for a ``lim``
clamped below ``n_part`` (nvcc 12.9): the kernel then took every wanted
page as the head.  This script builds a copy of ``pbm_timeline.cu`` with
the test moved back to the call site (``select_head`` without its own
test, called only when ``lim != n_part``) with the library's own nvcc
flags, and runs that copy's ``fifo_grant`` and the shipped library's on
queues where ``pops = n_part - 1`` clamps ``lim`` below ``n_part`` (and on
controls where it does not), each against the plain version
(``ref.fifo_grant_ref``).  Mismatches of the copy where the shipped
library has none mean the compiler still folds the test wrongly.

Prints one JSON object: the nvcc version, the cases, the mismatches of
each build, and the verdict.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

#: the fifo_grant call of select_head, and its test at the call site
CALL = "  const Head h = select_head(s_u, P, lim, n_part, s_hist, s_pick);\n"
AT_CALL = ("  Head h;\n"
           "  if (lim == n_part)\n"
           "    h = Head{1u, 31, 0, P - n_part};\n"
           "  else\n"
           "    h = select_head_raw(s_u, P, lim, n_part, s_hist, s_pick);\n")
TEST = "  if (m >= n_part) return Head{1u, 31, 0, P - n_part};\n"


def test_at_call_site(src: str) -> str:
    """``pbm_timeline.cu`` with ``select_head_raw`` (``select_head`` less
    its own test) and fifo_grant testing ``lim == n_part`` itself."""
    start = src.index("__device__ Head select_head(")
    end = src.index("\n}\n", start) + 3
    body = src[start:end]
    if TEST not in body or src.count(CALL) != 1:
        raise RuntimeError("pbm_timeline.cu no longer has the form this "
                           "reproducer rewrites")
    raw = body.replace("select_head(", "select_head_raw(", 1).replace(
        TEST, "")
    return src[:end] + "\n" + raw + src[end:].replace(CALL, AT_CALL)


def build(src_text: str, out_dir: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    cu = os.path.join(out_dir, "pbm_timeline_fold.cu")
    so = os.path.join(out_dir, "libpbm_timeline_fold.so")
    with open(cu, "w") as f:
        f.write(src_text)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", so, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.pbm_fifo_grant.argtypes = [P_, P_, I_, P_, P_, P_, P_, P_,
                                   I_, I_, I_, I_, P_]
    lib.pbm_fifo_grant.restype = ctypes.c_int
    lib.pbm_init.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.pbm_init.restype = ctypes.c_int
    limits = (ctypes.c_int * 4)()
    if lib.pbm_init(limits):
        raise RuntimeError("pbm_init failed")
    return lib, tuple(limits)


def queue(L: int, P: int, n_part: int, g, dev):
    """Keys of ``n_part`` wanted pages a lane (stamp * 32768 + tie, no two
    alike), -1 elsewhere; sizes of 1 MiB; a budget that takes them all."""
    import torch
    key = torch.full((L, P), -1, dtype=torch.int32, device=dev)
    for lane in range(L):
        pages = torch.randperm(P, generator=g, device="cpu")[:n_part]
        vals = torch.randperm(1 << 20, generator=g, device="cpu")[:n_part]
        key[lane, pages.to(dev)] = vals.to(torch.int32).to(dev)
    sizes = torch.full((P,), float(1 << 20), device=dev)
    budget = torch.full((L,), 1e15, device=dev)
    return key, sizes, budget


def grant(lib, n_sort_fn, key, sizes, budget, pops, vmax):
    import torch
    from repro_torch.kernels import _build
    L, P = key.shape
    mask = torch.empty((L, P), dtype=torch.bool, device=key.device)
    nbytes = torch.empty((L,), dtype=torch.float32, device=key.device)
    n = torch.empty((L,), dtype=torch.int32, device=key.device)
    err = lib.pbm_fifo_grant(key.data_ptr(), sizes.data_ptr(), 0,
                             budget.data_ptr(), pops.data_ptr(),
                             mask.data_ptr(), nbytes.data_ptr(), n.data_ptr(),
                             L, P, vmax, n_sort_fn(P),
                             _build.stream_of(key))
    _build.raise_on(err, "fifo_grant")
    torch.cuda.synchronize()
    return mask, nbytes, n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import _build, pbm_timeline, ref
    if not torch.cuda.is_available():
        print("fifo_grant_fold: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    version = re.findall(r"release [\d.]+, V[\d.]+", nvcc)
    src = (_build.CSRC / "pbm_timeline.cu").read_text()
    shipped, limits = pbm_timeline.library(dev)

    def n_sort(P):
        return pbm_timeline._sort_len(P, limits[1])
    with tempfile.TemporaryDirectory() as tmp:
        folded, _ = build(test_at_call_site(src), tmp)
        g = torch.Generator().manual_seed(11)
        rows = []
        for P, n_part in ((256, 40), (1000, 300), (4096, 900), (4096, 17)):
            key, sizes, budget = queue(args.lanes, P, n_part, g, dev)
            for delta in (-1, -2, 0, 1):
                pops = torch.full((args.lanes,), n_part + delta,
                                  dtype=torch.int32, device=dev)
                vmax = min(1024, n_part + 8)
                want = ref.fifo_grant_ref(key, sizes, budget, pops,
                                          vmax=vmax)
                row = {"P": P, "n_part": n_part, "pops": n_part + delta,
                       "lim_below_n_part": delta < 0}
                for name, lib in (("shipped", shipped), ("at_call", folded)):
                    got = grant(lib, n_sort, key, sizes, budget, pops, vmax)
                    row[name] = sum(int((a != b).sum())
                                    for a, b in zip(got, want))
                rows.append(row)
    shipped_bad = sum(r["shipped"] for r in rows)
    at_call_bad = sum(r["at_call"] for r in rows if r["lim_below_n_part"])
    print(json.dumps({
        "nvcc": version, "lanes": args.lanes, "cases": rows,
        "shipped_mismatches": shipped_bad,
        "at_call_mismatches_lim_below": at_call_bad,
        "at_call_mismatches_controls": sum(
            r["at_call"] for r in rows if not r["lim_below_n_part"]),
        "verdict": ("folds: the test at the call site reads lim == n_part "
                    "true for a clamped lim" if at_call_bad else
                    "does not fold: the test at the call site is right")}),
        flush=True)
    return 0 if shipped_bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
