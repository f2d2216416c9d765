"""Share of a macro-step in which no operation runs on the device: 100 x
(1 - the device's busy seconds a macro-step in the profiler's trace of the
traced window, over the wall seconds a macro-step of the timed window).
The traced window's own wall time is not the denominator: under the
profiler each graph launch takes several times as long on the host (the
result line's ``busy_s`` / ``window_s`` show that window as it ran)."""


def read(run):
    t = run.trace
    steps = sum(p.steps for p in run.prefixes)
    if t is None or not t.steps or not t.device or not steps or run.window_s <= 0:
        return None
    busy_per_step = t.busy_s() / t.steps
    wall_per_step = run.window_s / steps
    return 100.0 * (1.0 - busy_per_step / wall_per_step)
