"""The loop nest's macro-steps (the runner's cheap and refresh steps, a
count) of one prefix sweep over the simulated seconds of its slowest
lane."""


def read(run):
    if not run.prefixes:
        return None
    p = run.prefixes[0]
    return p.steps / max(r.sim_s for r in p.lanes)
