"""Operations on the device (kernels, copies, fills) a macro-step, from
the profiler's trace of the traced window (a prefix sweep cut at the
traffic's ``short_sim_s``, replayed from the runner's graphs)."""


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.device:
        return None
    return len(t.device) / t.steps
