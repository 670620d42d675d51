"""A run's result line, a run without a card, the faults that the
comparison must catch, and BENCHMARK.json against the files it names."""

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import cell, spec
from portbench.tests.small import CELLS, small

torch.set_num_threads(1)
ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(cell_name, seed=2**31 + 5, sample=None, **kw):
    wl, cfg = small(cell_name)
    if sample is not None:
        wl["check"]["sample"] = sample
    return cell.run_cell(cell_name, seed, 0.2, False, "cpu", time.perf_counter(),
                         workload=wl, config=cfg, **kw)


@pytest.mark.parametrize("cell_name", CELLS)
def test_result_line_schema(cell_name):
    result, checks, _ = _run(cell_name)
    result["checks"] = checks
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] >= 0
    bench = spec.benchmark()
    e2e, _ = spec.cell_metrics(bench, cell_name)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    for m in e2e:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(checks) == set(spec.workload(cell_name)["check"]["limits"])
    assert all(set(v) == {"value", "limit"} for v in checks.values())


def test_run_without_a_card_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""


def _broken(kind):
    """A solve whose answers are wrong in the way ``kind`` says."""
    def wrap(solve):
        def broken(self, args):
            out = dict(solve(self, args))
            x0 = args[1]
            if kind == "state_unchanged":
                out["x"] = x0.clone()
            elif kind == "half_left_out":
                half = x0.shape[0] // 2
                out["x"] = torch.cat([out["x"][:half], x0[half:]])
            elif kind == "answer_altered":
                out["x"] = out["x"] + torch.tensor([0, 0, 0, 1e-3, 0, 0])
            elif kind == "one_answer_altered":
                out["x"] = out["x"].clone()
                out["x"][0, 3] += 1e-2
            elif kind == "flags_flipped":
                for k in ("converged", "success"):
                    if k in out:
                        out[k] = ~out[k]
            return out
        return broken
    return wrap


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered",
                                  "one_answer_altered", "flags_flipped"])
def test_faults_come_out_not_correct(cell_name, kind, monkeypatch):
    Entry = spec.entry(spec.workload(cell_name)["entry"])
    monkeypatch.setattr(Entry, "solve", _broken(kind)(Entry.solve))
    # one altered answer per call fails a run where the sample draws it: here every
    # problem is drawn
    result, checks, _ = _run(cell_name, sample=10**6 if kind == "one_answer_altered" else None)
    assert result["correct"] is False, checks


def test_benchmark_json_names_its_files():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.isfile(os.path.join(ROOT, c["file"]))
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert all(k in data for k in c["reduced"])
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    used = set()
    n_four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert n_four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}" and len(w["why"]) <= 200
        wl = spec.workload(w["name"])
        assert wl["config"] == w["config"] and wl["config"] in configs
        assert os.path.isfile(os.path.join(ROOT, "portbench", "entries", wl["entry"] + ".py"))
        assert callable(spec.loop(wl.get("loop", "closed")).run)
        used.add(w["config"])
        e2e, per_layer = spec.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        assert all(m["moves"] in names for m in per_layer)
    assert used == set(configs)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(spec.metric_reader(m["name"]))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
