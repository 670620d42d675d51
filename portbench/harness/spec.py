"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's root,
``portbench/workloads/<cell>.json`` (the configuration's name, the entry,
the traffic and the limits of the comparison),
``portbench/configs/<config>.json`` (the deployment),
``portbench/entries/<entry>.py``, ``portbench/loops/<loop>.py`` and
``portbench/metrics/<metric>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str) -> dict:
    return _json(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def entry(name: str):
    """The class ``Entry`` of ``portbench/entries/<name>.py``."""
    return importlib.import_module(f"portbench.entries.{name}").Entry


def loop(name: str):
    """The module ``portbench/loops/<name>.py``: ``run(entry, seconds, gen,
    sync, keep)`` drives the window and returns its ``window_s`` and
    ``call_s`` (and whatever else its metrics read)."""
    return importlib.import_module(f"portbench.loops.{name}")


def metric_reader(name: str):
    """The ``read(run)`` function of ``portbench/metrics/<name>.py`` or, where
    there is no such file, of the file named by ``name`` less its last
    dotted parts: ``call_ms_p90.map`` is read by ``call_ms_p90.py``, one
    reader for every split of a quantity."""
    stem = name
    while "." in stem and not os.path.isfile(os.path.join(HERE, "metrics", f"{stem}.py")):
        stem = stem.rsplit(".", 1)[0]
    path = os.path.join(HERE, "metrics", f"{stem}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: those
    that list it under ``workloads``; an end-to-end metric without the key
    in every cell; a per-layer metric without it in every cell that
    reports the end-to-end metric it ``moves``."""
    end_to_end = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench.get("per_layer", [])
                 if cell in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    return end_to_end, per_layer
