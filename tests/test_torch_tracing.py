"""The port's spans and counters (``cooper_mapper_torch/utils/profiling.py``)
on the CPU: tracing changes no answer, costs nothing when off, builds the
span tree the solves promise, counts what the solves' outputs say, and
stamps its host times on the clock the profiler stamps its events with."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_torch import config  # noqa: E402
from cooper_mapper_torch.config import RegistrationConfig, ScanMatchConfig  # noqa: E402
from cooper_mapper_torch.io import sim  # noqa: E402
from cooper_mapper_torch.ops import features  # noqa: E402
from cooper_mapper_torch.ops import odometry, scan_match  # noqa: E402
from cooper_mapper_torch.utils import cloud, profiling  # noqa: E402
from cooper_mapper_torch.utils.cloud import Cloud  # noqa: E402

B, WIDTH, RINGS = 3, 256, 16
GN = ("gn.residuals", "gn.normal_eqs", "gn.update")


def _tile(c, b):
    return Cloud(*(t[None].expand((b,) + tuple(t.shape)).contiguous()
                   for t in (c.xyz, c.mask, c.ring, c.rel_time)))


def _snug(c, granule=64):
    return cloud.compact(c, -(-int(c.mask.sum()) // granule) * granule)


@pytest.fixture(scope="module")
def sweeps():
    """Features of a sweep at rest and of one moving 0.36 m, 0.02 rad."""
    world = sim.make_room_world(seed=5, device="cpu")
    p0 = torch.eye(4)
    p0[1, 3] = 1.5
    c, s = np.cos(0.02), np.sin(0.02)
    motion = torch.tensor([[c, 0, s, 0.1], [0, 1, 0, 0], [-s, 0, c, 0.35], [0, 0, 0, 1]],
                          dtype=torch.float32)
    cfg = RegistrationConfig(n_rings=RINGS, max_points_per_ring=WIDTH)
    prev = features.extract_features(sim.scan_sweep(world, p0, p0, RINGS, WIDTH), cfg)
    cur = features.extract_features(sim.scan_sweep(world, p0, p0 @ motion, RINGS, WIDTH), cfg)
    return prev, cur


def _priors(seed, sd=0.01):
    return torch.from_numpy((sd * np.random.RandomState(seed).randn(B, 6)).astype(np.float32))


def _odometry(sweeps):
    prev, cur = sweeps
    cfg = config.vlp16().odometry
    args = (_tile(_snug(cur.sharp), B), _tile(_snug(cur.flat), B), _snug(prev.less_sharp),
            _snug(prev.less_flat), _priors(1), cfg)
    x, st = odometry.batch_odometry_solve(*args)
    return {"x": x, "converged": st.converged, "iter_used": st.iter_used,
            "n_matched": st.n_matched}, args


def _scan_match(sweeps):
    prev, cur = sweeps
    args = (_tile(_snug(cur.less_sharp), B), _tile(_snug(cur.less_flat), B),
            _snug(prev.less_sharp), _snug(prev.less_flat), _priors(2), ScanMatchConfig())
    res = scan_match.batch_scan_match(*args)
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}, args


SOLVES = {"odometry": _odometry, "scan_match": _scan_match}


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_answers_are_bit_identical_with_tracing_on_and_off(sweeps, solve):
    off, _ = SOLVES[solve](sweeps)
    with profiling.tracing() as tr:
        on, _ = SOLVES[solve](sweeps)
    assert tr.spans
    for k, v in off.items():
        assert torch.equal(v, on[k]), k


def test_tracing_off_leaves_no_trace(sweeps):
    # off: span() is one shared null context, count() launches no op, and a
    # profiler session sees no span of the program
    assert profiling.span("a") is profiling.span("b")
    names = {"odometry.solve", "odometry.refresh", "scan_match.solve", "scan_match.search",
             "scan_match.fit", "scan_match.score"} | set(GN)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _odometry(sweeps)
        _scan_match(sweeps)
    assert not {e.name for e in prof.events()} & names
    mask = torch.ones(8, dtype=torch.bool)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.count("rows", mask)
    assert not prof.events()


def _tree(tr):
    by_call = {}
    for r in tr.spans:
        by_call.setdefault(r.call, []).append(r)
    return by_call


def _names(spans):
    out = {}
    for r in spans:
        out[r.name] = out.get(r.name, 0) + 1
    return out


def test_odometry_span_tree(sweeps):
    # two calls at vlp16().odometry: 25 iterations, a refresh every 5
    with profiling.tracing() as tr:
        _odometry(sweeps)
        _odometry(sweeps)
    calls = _tree(tr)
    assert len(calls) == 2
    for call_id, spans in calls.items():
        root = spans[0]
        assert (root.name, root.id, root.parent) == ("odometry.solve", call_id, None)
        assert _names(spans) == {"odometry.solve": 1, "odometry.refresh": 5,
                                 "gn.residuals": 25, "gn.normal_eqs": 25, "gn.update": 25}
        assert all(r.parent == root.id and r.call == call_id for r in spans[1:])
        assert all(r.start_ns >= root.start_ns and r.end_ns <= root.end_ns for r in spans)


def test_scan_match_span_tree(sweeps):
    # ScanMatchConfig(): 10 iterations, then the score gate's build
    with profiling.tracing() as tr:
        _scan_match(sweeps)
    (call_id, spans), = _tree(tr).items()
    root = spans[0]
    assert (root.name, root.id, root.parent) == ("scan_match.solve", call_id, None)
    assert _names(spans) == {"scan_match.solve": 1, "scan_match.search": 11,
                             "scan_match.fit": 11, "gn.residuals": 11, "gn.normal_eqs": 10,
                             "gn.update": 10, "scan_match.score": 1}
    score = next(r for r in spans if r.name == "scan_match.score")
    inside = [r for r in spans if r.parent == score.id]
    assert [r.name for r in inside] == ["scan_match.search", "scan_match.fit", "gn.residuals"]
    assert all(r.parent == root.id for r in spans[1:] if r not in inside)
    assert all(r.call == call_id for r in spans)


def test_counters_equal_the_solves_own_sums(sweeps):
    with profiling.tracing() as tr:
        out, args = _odometry(sweeps)
    totals = tr.counters()
    sharp, flat = args[0], args[1]
    root = totals["odometry.solve"]
    assert root == {"query_points": int(sharp.mask.sum() + flat.mask.sum()), "lanes": B,
                    "steps": 25, "lane_steps": int(out["iter_used"].sum())}
    last_eqs = [r for r in tr.spans if r.name == "gn.normal_eqs"][-1]
    assert last_eqs.counts == {"rows": int(out["n_matched"].sum())}
    assert sum(r.counts["rows"] for r in tr.spans if r.name == "gn.normal_eqs") \
        == totals["gn.normal_eqs"]["rows"]
    assert 0 < totals["odometry.refresh"]["race_matched"] <= 5 * root["query_points"]

    with profiling.tracing() as tr:
        out, args = _scan_match(sweeps)
    totals = tr.counters()
    corner, surf = args[0], args[1]
    assert totals["scan_match.solve"] == {
        "query_points": int(corner.mask.sum() + surf.mask.sum()), "lanes": B, "steps": 10,
        "lane_steps": int(out["iter_used"].sum())}
    assert bool(out["enough_ref"].all())
    last_eqs = [r for r in tr.spans if r.name == "gn.normal_eqs"][-1]
    assert last_eqs.counts == {"rows": int(out["n_matched"].sum())}
    # the score gate's build: its fits are the matches of match_fraction
    score = next(r for r in tr.spans if r.name == "scan_match.score")
    fit = next(r for r in tr.spans if r.name == "scan_match.fit" and r.parent == score.id)
    total = (corner.mask.sum(-1) + surf.mask.sum(-1)).float()
    assert fit.counts["fits_accepted"] == int(torch.round(out["match_fraction"] * total).sum())
    search = next(r for r in tr.spans if r.name == "scan_match.search" and r.parent == score.id)
    assert fit.counts["fits_accepted"] <= search.counts["knn_gated"]


def test_race_pair_counters_count_the_listed_walk(sweeps):
    # each refresh's four races (nn1 and nn1_masked of the corner search,
    # nn1 and bc_races of the surf one) count the valid queries x valid
    # reference points they walk, and the padded slots they would
    with profiling.tracing() as tr:
        _, args = _odometry(sweeps)
    sharp, flat, corner, surf = args[:4]
    walked = 2 * int(sharp.mask.sum() * corner.mask.sum() + flat.mask.sum() * surf.mask.sum())
    padded = 2 * B * (sharp.capacity * corner.capacity + flat.capacity * surf.capacity)
    refreshes = [r for r in tr.spans if r.name == "odometry.refresh"]
    tr.counters()
    assert len(refreshes) == 5 and walked < padded
    for r in refreshes:
        assert (r.counts["race_pairs_walked"], r.counts["race_pairs_padded"]) == (walked, padded)


def test_spans_share_the_profilers_clock(sweeps):
    # every in-memory span lies within its record_function event's host
    # interval, on the profiler's clock, to 50 us
    with profiling.tracing() as tr:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _odometry(sweeps)
            _scan_match(sweeps)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    names = {r.name for r in tr.spans}
    events = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name in names:
            events.setdefault(e.name, []).append(e)
    assert sum(map(len, events.values())) == len(tr.spans)
    for r in tr.spans:
        e = events[r.name].pop(0)
        a = start_ns + e.time_range.start * 1e3
        b = start_ns + e.time_range.end * 1e3
        assert a - 50e3 <= r.start_ns <= r.end_ns <= b + 50e3, r.name


def test_self_time_leaves_out_the_children():
    tr = profiling.Trace()
    tr.spans = [profiling.SpanRecord("root", 1, None, 1, 0, 100),
                profiling.SpanRecord("a", 2, 1, 1, 10, 40),
                profiling.SpanRecord("b", 3, 1, 1, 50, 60),
                profiling.SpanRecord("c", 4, 2, 1, 20, 25)]
    assert tr.self_ns() == {1: 60, 2: 25, 3: 10, 4: 5}


def test_stage_spans_hold_the_solves_and_tallies_count_always(sweeps):
    timer = profiling.StageTimer()
    before = profiling.COUNTS["test.launches"]
    profiling.tally("test.launches", 2)
    with profiling.tracing() as tr:
        with timer.stage("odometry", sync="cpu"):
            profiling.tally("test.launches")
            _odometry(sweeps)
    assert profiling.COUNTS["test.launches"] == before + 3
    stage, root = tr.spans[0], tr.spans[1]
    assert (stage.name, stage.parent, stage.call) == ("odometry", None, stage.id)
    assert (root.name, root.parent, root.call) == ("odometry.solve", stage.id, root.id)
    assert tr.counters()["odometry"]["test.launches"] == 1
    assert timer.calls["odometry"] == 1


def test_trace_writes_the_spans_into_the_chrome_trace(sweeps, tmp_path):
    with profiling.trace(str(tmp_path)) as tr:
        _odometry(sweeps)
    assert tr.spans and profiling._TRACE is None
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"odometry.solve", "odometry.refresh", "gn.update"} <= names
