"""Seconds from the process's start to the first timed sweep (host
clock): imports, the kernels' build or load, the workload's generation and
compilation, the runner and its configs, and the warm sweep that captures
its graphs."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
