"""The port's PDT-lite and append snapshots (paper §2.1) against the JAX
package's ``repro.core.pdt`` and ``repro.core.snapshots``.

Both are pure Python; the same seeded numpy op sequence is applied to
each package's objects, and every observable — SID/RID translations in
both directions, visible counts, errors raised, the trimmed RID ranges an
out-of-order CScan delivers, commits and aborts, shared/local chunk
classification — must be EQUAL.  The sequences are drawn with numpy from
fixed seeds, so these tests need no property-testing package.
"""

import numpy as np
import pytest

from repro.core import pdt as JP
from repro.core import snapshots as JS
from repro_torch.core import pdt as TP
from repro_torch.core import snapshots as TS

SEEDS = range(8)


def _apply_ops(pkg, seed):
    """A random sequence of inserts, deletes (some repeated, some out of
    range) and modifications on a PDT of each package; returns the PDT and
    the outcome of every op (None, or the error's type)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    p = pkg.PDT(n)
    outcomes = []
    for _ in range(int(rng.integers(0, 60))):
        kind = rng.choice(["insert", "delete", "modify"], p=[0.5, 0.35, 0.15])
        sid = int(rng.integers(-2, n + 3))
        try:
            if kind == "insert":
                p.insert(sid, int(rng.integers(0, 100)))
            elif kind == "delete":
                p.delete(sid)
            else:
                p.modify(sid, int(rng.integers(0, 100)))
            outcomes.append(None)
        except ValueError:
            outcomes.append((kind, sid, "ValueError"))
    return p, outcomes


def _observe_pdt(p):
    out = {"n_visible": p.n_visible,
           "low": [p.sid_to_rid_low(s) for s in range(p.n_stable + 1)],
           "high": [p.sid_to_rid_high(s) for s in range(p.n_stable + 1)],
           "rid": [p.rid_to_sid(r) for r in range(p.n_visible)],
           "deleted": [p.is_deleted(s) for s in range(p.n_stable)],
           "stacked": p.stacked_on().n_stable}
    for bad in (-1, p.n_stable + 1):
        with pytest.raises(ValueError):
            p.sid_to_rid_low(bad)
    with pytest.raises(ValueError):
        p.rid_to_sid(p.n_visible)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_pdt_translation_equals_the_jax_package(seed):
    got, got_ops = _apply_ops(TP, seed)
    want, want_ops = _apply_ops(JP, seed)
    assert got_ops == want_ops
    assert _observe_pdt(got) == _observe_pdt(want)
    # tests/test_pdt.py's round-trip property, on the port
    obs = _observe_pdt(got)
    assert obs["low"] == sorted(obs["low"])
    for r, sid in enumerate(obs["rid"]):
        assert obs["low"][sid] <= r <= obs["high"][sid]


def _deliver(pkg, seed):
    """Chunks of a random PDT delivered in a random order (the ABM's
    out-of-order delivery), some twice: the trimmed RID ranges of each."""
    rng = np.random.default_rng(100 + seed)
    p, _ = _apply_ops(pkg, seed)
    cuts = sorted({0, p.n_stable, *rng.integers(0, p.n_stable + 1,
                                               size=4).tolist()})
    chunks = list(zip(cuts[:-1], cuts[1:]))
    order = rng.permutation(len(chunks)).tolist()
    order += rng.integers(0, len(chunks), size=2).tolist()
    m = pkg.CScanMergeState()
    out = [m.deliver_chunk(p, *chunks[i]) for i in order]
    out.append(m.deliver_chunk(p, 3, 3))                # empty chunk
    return out, m.produced, m.produced_count, p.n_visible, \
        p._inserts_at(p.n_stable)


@pytest.mark.parametrize("seed", SEEDS)
def test_cscan_merge_state_equals_the_jax_package(seed):
    got, want = _deliver(TP, seed), _deliver(JP, seed)
    assert got == want
    ranges, _produced, count, n_visible, appended = got
    if appended == 0:
        # tests/test_pdt.py's property (inserts anchored inside the stable
        # range): every visible RID is produced exactly once
        assert count == n_visible
        flat = [r for rs in ranges for lo, hi in rs for r in range(lo, hi)]
        assert sorted(flat) == list(range(n_visible))


def _snapshot_story(pkg, seed):
    """A random sequence of begins, appends, commits and checkpoints on one
    table, with several transactions live at once.  Snapshot ids are a
    per-package counter, so every outcome names snapshots by their
    position in the story, not by id."""
    rng = np.random.default_rng(200 + seed)
    next_page = [0]

    def pages(k):
        out = list(range(next_page[0], next_page[0] + k))
        next_page[0] += k
        return out

    cols = ("a", "b")
    base = {c: pages(int(rng.integers(1, 6))) for c in cols}
    master = pkg.Snapshot(table="t", pages=base)
    mgr = pkg.SnapshotManager(master)
    snaps, live, log = [master], {}, []
    txn = 0

    def name(s):
        return next(i for i, x in enumerate(snaps) if x is s)

    for _ in range(int(rng.integers(5, 25))):
        op = rng.choice(["begin", "append", "commit", "checkpoint"],
                        p=[0.35, 0.3, 0.3, 0.05])
        if op == "begin" or not live:
            s = mgr.begin(txn)
            live[txn] = s
            log.append(("begin", txn, name(s)))
            txn += 1
        elif op == "append":
            t = sorted(live)[int(rng.integers(0, len(live)))]
            s = live[t].append({c: pages(int(rng.integers(0, 3)))
                                for c in cols})
            snaps.append(s)
            live[t] = s
            log.append(("append", t, name(s), s.n_chunks(),
                        snaps[0].is_prefix_of(s)))
        elif op == "commit":
            t = sorted(live)[int(rng.integers(0, len(live)))]
            ok = mgr.commit(t, live.pop(t))
            log.append(("commit", t, ok, name(mgr.master)))
        else:
            s = mgr.checkpoint({c: pages(int(rng.integers(1, 4)))
                                for c in cols})
            snaps.append(s)
            log.append(("checkpoint", name(s), s.version))
        live_snaps = list(live.values())
        for chunk_pages in (1, 2):
            shared, local = pkg.classify_chunks(live_snaps, chunk_pages)
            log.append(("classify", chunk_pages, sorted(shared),
                        sorted((name(s), sorted(local[s.sid]))
                               for s in live_snaps)))
        if len(live_snaps) >= 2:
            a, b = live_snaps[0], live_snaps[-1]
            log.append(("prefix", a.common_prefix_len(b),
                        a.is_prefix_of(b)))
    with pytest.raises(ValueError):
        mgr.commit(10_000, master)
    return log


@pytest.mark.parametrize("seed", SEEDS)
def test_snapshots_equal_the_jax_package(seed):
    assert _snapshot_story(TS, seed) == _snapshot_story(JS, seed)


def test_two_concurrent_appenders_cannot_both_commit():
    """The paper's rule, on the port: of two appenders started on one
    master only the first to commit wins; a read-only transaction commits;
    a checkpoint starts a disjoint version that shares no chunk."""
    m = TS.Snapshot(table="t", pages={"a": [0, 1, 2], "b": [10, 11, 12]})
    mgr = TS.SnapshotManager(m)
    s1 = mgr.begin(1).append({"a": [3], "b": [13]})
    s2 = mgr.begin(2).append({"a": [4], "b": [14]})
    ro = mgr.begin(3)
    assert mgr.commit(1, s1) is True and mgr.master is s1
    assert mgr.commit(2, s2) is False
    assert mgr.commit(3, ro) is False          # master moved: not promoted
    shared, local = TS.classify_chunks([s1, s2])
    assert shared == {0, 1, 2} and local[s1.sid] == {3}
    new = mgr.checkpoint({"a": [20], "b": [30]})
    shared, local = TS.classify_chunks([s1, new])
    assert shared == set() and local[new.sid] == {0}
