"""B1-B3's share of their roofline in the traced window: the sum over their
launches of each call's least time (``portbench.roofline``: bytes once at
the HBM rate against a sort's comparisons at the f32 rate; at these shapes
the bytes bound it) over the sum of their device time in the profiler's
trace.  Nothing to read where no launch of them was traced, or where the
page-split kernels ran (a call there is several launches, which this
per-call bound does not price)."""

from portbench import roofline


def read(run):
    t = run.trace
    if t is None or run.device_kind not in roofline.PEAKS:
        return None
    bound = busy = 0.0
    for name, s, e in t.device:
        if any(k in name for k in roofline.SPLIT_KERNELS):
            return None
        k = roofline.kernel_of(name)
        if k is None:
            continue
        bound += roofline.bound_s(k, run.lanes, run.pages, run.device_kind)[0]
        busy += (e - s) / 1e9
    if busy <= 0:
        return None
    return 100.0 * bound / busy
