"""Lane-simulated seconds per wall second: the simulated seconds every
lane of every prefix sweep of the window advanced (to its end, read from
its final state), over the window's wall seconds (host clock)."""


def read(run):
    if not run.prefixes or run.window_s <= 0:
        return None
    sim = sum(r.sim_s for p in run.prefixes for r in p.lanes)
    return sim / run.window_s
