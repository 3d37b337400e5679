"""The port's trackers against the reference's, case for case.

Replays the vector-tracker cases of ``tests/test_tracker.py`` against both
packages: the port's ``VectorTemporalTracker`` equals its scalar
``TemporalTracker`` (dense and masked updates), its events do not depend on
the order in which streams' windows reach it, and a state dict restored
into a fresh tracker replays bitwise; in every case the port's states and
events equal the reference trackers' on the same inputs.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serving import tracker as jtr  # noqa: E402
from repro_torch.serving import tracker as ttr  # noqa: E402

PACKAGES = {"reference": jtr, "port": ttr}


def _events(evs) -> list:
    """Events of either package as comparable tuples."""
    return [dataclasses.astuple(e) for e in evs]


def _all_events(per_stream) -> list:
    return [_events(evs) for evs in per_stream]


def _states(state) -> tuple:
    return (state["idx"].copy(), state["smoothed"].copy(), state["active"].copy())


def _vector_run(mod, p, masks, kw):
    """States after every round and the finalized events of one package's
    vector tracker."""
    vec = mod.VectorTemporalTracker(p.shape[1], **kw)
    states = [_states(vec.update(p[t], None if masks is None else masks[t]))
              for t in range(p.shape[0])]
    return states, _all_events(vec.finalize())


def _assert_states_equal(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        for x, y in zip(sa, sb):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def test_vector_matches_scalar_dense_updates_in_both_packages():
    rng = np.random.default_rng(11)
    n, steps = 6, 400
    p = rng.random((steps, n))
    kw = dict(ema_alpha=0.3, enter_threshold=0.6, exit_threshold=0.4, min_duration=2)
    runs = {}
    for name, mod in PACKAGES.items():
        vec = mod.VectorTemporalTracker(n, **kw)
        scalars = [mod.TemporalTracker(**kw) for _ in range(n)]
        for t in range(steps):
            st = vec.update(p[t])
            for s in range(n):
                ss = scalars[s].update(float(p[t, s]))
                assert st["idx"][s] == ss["idx"]
                assert st["smoothed"][s] == ss["smoothed"]
                assert st["active"][s] == ss["active"]
        vev = _all_events(vec.finalize())
        assert vev == [_events(sc.finalize()) for sc in scalars]
        runs[name] = vev
    assert runs["port"] == runs["reference"]
    assert sum(len(e) for e in runs["port"]) > 0  # the comparison is not vacuous
    _assert_states_equal(*(_vector_run(mod, p, None, kw)[0] for mod in PACKAGES.values()))


def test_vector_masked_updates_freeze_streams_in_both_packages():
    rng = np.random.default_rng(12)
    n, steps = 4, 250
    p = rng.random((steps, n))
    masks = rng.random((steps, n)) < 0.6
    kw = dict(ema_alpha=0.5, enter_threshold=0.55, exit_threshold=0.45, min_duration=1)
    runs = {}
    for name, mod in PACKAGES.items():
        states, vev = _vector_run(mod, p, masks, kw)
        scalars = [mod.TemporalTracker(**kw) for _ in range(n)]
        for t in range(steps):
            for s in range(n):
                if masks[t, s]:
                    scalars[s].update(float(p[t, s]))
        assert vev == [_events(sc.finalize()) for sc in scalars]
        runs[name] = (states, vev)
    assert sum(len(e) for e in runs["port"][1]) > 0
    assert runs["port"][1] == runs["reference"][1]
    _assert_states_equal(runs["port"][0], runs["reference"][0])


def _schedules(p, rng):
    n, steps = p.shape[1], p.shape[0]

    def round_robin():
        for t in range(steps):
            yield p[t], np.ones(n, bool)

    def stream_major():  # one whole stream drains before the next starts
        for s in range(n):
            for t in range(steps):
                mask = np.zeros(n, bool)
                mask[s] = True
                yield p[t], mask

    def random_shards():  # a random subset advances, e.g. the first shard harvested
        cursor = np.zeros(n, np.int64)
        while (cursor < steps).any():
            mask = (rng.random(n) < 0.5) & (cursor < steps)
            if not mask.any():
                continue
            probs = np.zeros(n)
            probs[mask] = p[cursor[mask], np.flatnonzero(mask)]
            yield probs, mask
            cursor[mask] += 1

    return {"round_robin": round_robin, "stream_major": stream_major,
            "random_shards": random_shards}


@pytest.mark.parametrize("schedule", ["round_robin", "stream_major", "random_shards"])
def test_vector_events_invariant_to_dispatch_order_in_both_packages(schedule):
    """Sharded or double-buffered harvests change when a stream's window
    reaches the tracker relative to other streams, never a stream's own
    order: every schedule gives each stream's scalar replay, in both
    packages, and the port's events equal the reference's."""
    n, steps = 5, 120
    p = np.random.default_rng(13).random((steps, n))
    kw = dict(ema_alpha=0.5, enter_threshold=0.55, exit_threshold=0.45, min_duration=1)
    runs = {}
    for name, mod in PACKAGES.items():
        ref = [_events(mod.track_stream(p[:, s], **kw)) for s in range(n)]
        assert sum(len(e) for e in ref) > 0
        vec = mod.VectorTemporalTracker(n, **kw)
        for probs, mask in _schedules(p, np.random.default_rng(14))[schedule]():
            vec.update(np.asarray(probs, np.float64), mask)
        runs[name] = _all_events(vec.finalize())
        assert runs[name] == ref
    assert runs["port"] == runs["reference"]


def test_state_dict_restore_replays_bitwise_across_packages():
    """Snapshot mid-sequence, load into a fresh tracker, replay the tail:
    the trajectory and events are the uninterrupted tracker's, bitwise, in
    each package, and a state dict crosses between the packages (port ->
    reference and reference -> port) with the same result."""
    rng = np.random.default_rng(31)
    n, steps, cut = 4, 300, 117
    p = rng.random((steps, n))
    masks = rng.random((steps, n)) < 0.7
    kw = dict(ema_alpha=0.4, enter_threshold=0.55, exit_threshold=0.45, min_duration=2)
    whole, want_events = _vector_run(ttr, p, masks, kw)
    assert sum(len(e) for e in want_events) > 0
    snaps = {}
    for name, mod in PACKAGES.items():
        first = mod.VectorTemporalTracker(n, **kw)
        for t in range(cut):
            first.update(p[t], masks[t])
        snaps[name] = first.state_dict()
    for src, dst in (("port", "port"), ("reference", "reference"), ("port", "reference"),
                     ("reference", "port")):
        revived = PACKAGES[dst].VectorTemporalTracker(n, **kw)
        revived.load_state_dict(snaps[src])
        tail = [_states(revived.update(p[t], masks[t])) for t in range(cut, steps)]
        _assert_states_equal(tail, whole[cut:])
        assert _all_events(revived.finalize()) == want_events, (src, dst)
