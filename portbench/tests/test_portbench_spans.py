"""The span pass (``harness/spans.py``): its reduction on a synthetic event
list, its readers without a card, and the pass itself at CPU size."""

import io
import types

import pytest
import torch

from cooper_mapper_torch.utils import profiling
from portbench.harness import spans, spec
from portbench.tests.small import CELLS, small

torch.set_num_threads(1)
NEW = ("search_busy_ms.odometry", "search_busy_ms.map", "fit_busy_ms.map",
       "gn_busy_ms.odometry", "gn_busy_ms.map", "gn_idle_ms.odometry", "gn_idle_ms.map",
       "active_lane_share.odometry", "active_lane_share.map", "match_share.odometry",
       "match_share.map")


def _records():
    rec = profiling.SpanRecord
    return [rec("odometry.solve", 1, None, 1, 0, 100_000, {"lanes": 4, "steps": 5,
                                                           "query_points": 10,
                                                           "lane_steps": 12}),
            rec("odometry.refresh", 2, 1, 1, 11_000, 40_000),
            rec("gn.normal_eqs", 3, 1, 1, 42_000, 48_000, {"rows": 9}),
            rec("gn.update", 4, 1, 1, 50_000, 90_000)]


RANGES = [("odometry.solve", 0.0, 100.0), ("odometry.refresh", 11.0, 40.0),
          ("gn.normal_eqs", 42.0, 48.0), ("gn.update", 50.0, 90.0)]
LAUNCHES = {101: 12.0, 102: 55.0, 103: 5.0, 104: 95.0}
ACTIVITIES = [("k1", 20.0, 30.0, 101), ("k2", 60.0, 70.0, 102), ("k3", 8.0, 10.0, 103),
              ("k4", 96.0, 99.0, 104), ("lost", 80.0, 81.0, 999)]


def test_busy_and_idle_go_to_the_innermost_span():
    records = _records()
    tr = profiling.Trace()
    tr.spans = records
    p = spans.reduce(records, tr.self_ns(), RANGES, LAUNCHES, ACTIVITIES)
    got = {k: (v["busy_ms"] * 1e3, v["idle_ms"] * 1e3) for k, v in p["spans"].items()}
    # busy by the span open at the launch; idle by the span open when the
    # gap began: 10-20 in the root, 30-60 in the refresh, 70-96 in the update
    assert got == {"odometry.solve": (5.0, 10.0), "odometry.refresh": (10.0, 30.0),
                   "gn.normal_eqs": (0.0, 0.0), "gn.update": (10.0, 26.0)}
    assert p["spans"]["odometry.solve"]["host_self_ms"] == pytest.approx(0.025)
    assert p["unattributed"] == {"activities": 1.0, "ms": pytest.approx(1e-3),
                                 "names": [("lost", 1)]}
    assert p["root_self_busy_share"] == pytest.approx(5 / 25)
    assert p["calls"][0]["spans"] == {"odometry.solve": 1, "odometry.refresh": 1,
                                      "gn.normal_eqs": 1, "gn.update": 1}
    run = types.SimpleNamespace(span_pass=p)
    assert spans.active_lane_share(run) == pytest.approx(100 * 12 / 20)
    assert spans.match_share(run) == pytest.approx(100 * 9 / 10)
    gn = {"odometry.solve": spans.GN}
    assert spans.span_ms(run, "busy_ms", gn) == pytest.approx(0.010)
    assert spans.span_ms(run, "idle_ms", gn) == pytest.approx(0.026)
    assert spans.span_ms(run, "busy_ms", {"scan_match.solve": ("scan_match.fit",)}) is None


def _event(name, dev, a, b, eid, annotation=False):
    return types.SimpleNamespace(name=name, device_type=dev, id=eid, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def test_user_annotations_are_not_activities():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_event("odometry.solve", cpu, 0, 100, 1, True),
              _event("cudaLaunchKernel", cpu, 12, 13, 101),
              _event("aten::mul", cpu, 11, 14, 7),
              _event("k1", cuda, 20, 30, 101),
              _event("odometry.solve", cuda, 1, 99, 1),          # the range's device side
              _event("gpu_user_annotation", cuda, 5, 9, 2, True)]
    ranges, launches, acts = spans.from_profiler(events, {"odometry.solve"})
    assert ranges == [("odometry.solve", 0, 100)]
    assert launches == {101: 12}
    assert acts == [("k1", 20, 30, 101)]


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    run = types.SimpleNamespace(cell=CELLS[0])
    assert spec.metric_reader(name)(run) is None


@pytest.mark.parametrize("cell_name", CELLS[:2])
def test_pass_at_cpu_size(cell_name):
    wl, cfg = small(cell_name)
    out = io.StringIO()
    p = spans.measure(cell_name, wl, cfg, "cpu", profiling, calls=2, out=out)
    odometry = cell_name.startswith("vlp16_odometry")
    want = ({"odometry.solve": 1, "odometry.refresh": 5, "gn.residuals": 25,
             "gn.normal_eqs": 25, "gn.update": 25} if odometry else
            {"scan_match.solve": 1, "scan_match.search": 11, "scan_match.fit": 11,
             "gn.residuals": 11, "gn.normal_eqs": 10, "gn.update": 10, "scan_match.score": 1})
    assert [c["spans"] for c in p["calls"]] == [want, want]
    assert p["on_off"]["bit_identical"] and p["unpaired_spans"] == 0
    text = out.getvalue()
    assert all(name in text for name in want)
    run = types.SimpleNamespace(span_pass=p)
    assert 0 < spans.active_lane_share(run) <= 100 and 0 < spans.match_share(run) <= 100
