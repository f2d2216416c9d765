"""Wall milliseconds of one batched macro-step: the window's wall time
(host clock) over every macro-step its sweeps ran."""


def read(run):
    steps = sum(p.steps for p in run.prefixes)
    if not steps:
        return None
    return run.window_s * 1e3 / steps
