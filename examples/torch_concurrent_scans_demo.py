"""The paper end-to-end on the PyTorch / CUDA port: all seven policies on
the microbenchmark + the sharing-potential analysis (Figs 11/17 in
miniature), the port's counterpart of ``examples/concurrent_scans_demo.py``.

  PYTHONPATH=src python examples/torch_concurrent_scans_demo.py [--scale 0.1]

The demo drives the port's event engine (``repro_torch.core``), pure
Python on the host, as its namesake drives the JAX package's; it takes no
``--device``: nothing of it runs on a card.  The batched simulator on the
card is ``repro_torch.core.array_sim``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import (  # noqa: E402
    EngineConfig, run_workload, simulate_belady,
)
from repro_torch.core.policy_registry import names as policy_names  # noqa: E402
from repro_torch.core.stats import sharing_potential  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    make_lineitem_db, micro_accessed_bytes, micro_streams,
)

POLICIES = policy_names(backend="event")  # all seven, registry order


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1,
                    help="fraction of SF30 lineitem (1.0 = paper scale)")
    ap.add_argument("--buffer", type=float, default=0.4)
    ap.add_argument("--streams", type=int, default=8)
    args = ap.parse_args(argv)

    # (512 KiB pages at scale 1.0; the namesake's `512 << 10 * scale`
    # shifts by a float and raises)
    db = make_lineitem_db(scale_tuples=int(180e6 * args.scale),
                          page_bytes=max(16 << 10,
                                         int((512 << 10) * args.scale)))
    ws = micro_accessed_bytes(db)
    streams = micro_streams(db, n_streams=args.streams, queries_per_stream=16,
                            seed=3)
    print(f"lineitem scale={args.scale:.2f}: working set {ws/1e6:.0f}MB, "
          f"buffer {args.buffer:.0%}, {args.streams} streams x 16 queries\n")
    print(f"{'policy':10s} {'avg stream (s)':>15s} {'total I/O (GB)':>15s}")
    pbm_run = None
    for pol in POLICIES:
        cfg = EngineConfig(
            bandwidth=700e6, buffer_bytes=int(args.buffer * ws),
            record_trace=(pol == "pbm"), pbm_time_slice=0.1 * args.scale,
        )
        r = run_workload(db, streams, pol, cfg)
        star = {"pbm": "  <- the paper's contribution",
                "pbm_lru": "  <- paper future-work, built",
                "attach": "  <- paper future-work, built"}.get(pol, "")
        print(f"{pol:10s} {r.avg_stream_time:15.2f} {r.io_gb:15.2f}{star}")
        if pol == "pbm":
            pbm_run = r
    # paper's OPT methodology: Belady on the PBM trace
    _, belady_bytes = simulate_belady(
        pbm_run.trace, page_sizes=pbm_run.page_sizes,
        capacity_bytes=int(args.buffer * ws))
    print(f"{'opt(trace)':10s} {'-':>15s} {belady_bytes/1e9:15.2f}"
          f"  <- Belady on PBM reference trace")
    sp = sharing_potential(pbm_run)
    print(f"\nsharing potential: {sp.reusable_fraction:.0%} of in-demand bytes "
          f"wanted by >=2 scans (paper Fig 17)")


if __name__ == "__main__":
    main()
