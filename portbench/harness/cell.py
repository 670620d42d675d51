"""One run of one cell: set-up, the measured window (driven by the loop
that the workload names, ``portbench/loops/<loop>.py``, by default
``closed``), the traced calls of a ``--trace 1`` run, the comparison with
the plain reference, and the metrics, read by the readers that
``BENCHMARK.json`` names for the cell."""

from __future__ import annotations

import contextlib
import time
import types

import torch

from ..inputs import pool as pool_lib
from . import compare, spec
from . import trace as trace_lib

# streams of draws of one seed (the pool is stream 0, inputs/pool.py)
CALL_STREAM, SAMPLE_STREAM = 1, 2
# calls at the cell's shapes before the window, and after it under the profiler
WARM_CALLS, TRACED_CALLS = 1, 3


def sync(device):
    """Wait for the card's queued work (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _cat(parts: list) -> dict:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


@contextlib.contextmanager
def fp32_matmuls():
    """PyTorch's float32 matmuls in float32 (TF32 off), as the reference
    computes them; the setting the caller had comes back after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sample(problems: list, outputs: list, n: int, seed: int, device):
    """A sample, drawn from the seed, of ``n`` of the calls' problems:
    (their identities, the program's answers to them)."""
    every_p, every_out = _cat(problems), _cat(outputs)
    _, gen = pool_lib.generators(seed, SAMPLE_STREAM, device)
    pick = torch.randperm(every_p["x0"].shape[0], generator=gen, device=device)[:n]
    return ({k: v[pick] for k, v in every_p.items()},
            {k: v[pick] for k, v in every_out.items()})


def reference(entry, picked: dict, chunk: int, tf32: bool = False) -> dict:
    """The plain reference's answers to the picked problems, ``chunk`` at a
    time; with ``tf32`` the control's (``reference/solve.py``)."""
    n = picked["x0"].shape[0]
    with fp32_matmuls():
        return _cat([entry.reference({k: v[s:s + chunk] for k, v in picked.items()}, tf32)
                     for s in range(0, n, chunk)])


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             bench: dict | None = None, workload: dict | None = None,
             config: dict | None = None):
    """Run cell ``name`` once.  Returns (the result's fields, the numbers
    compared with their limits, the run record the metrics were read
    from).  ``workload`` / ``config`` replace the cell's files (the tests
    run the harness at CPU sizes with them)."""
    bench = bench if bench is not None else spec.benchmark()
    wl = workload or spec.workload(name)
    cfg = config or spec.config(wl["config"])
    t0 = time.perf_counter()
    entry = spec.entry(wl["entry"])(cfg, wl["traffic"], seed, device)
    sync(device)
    t1 = time.perf_counter()
    _, gen = pool_lib.generators(seed, CALL_STREAM, device)
    for _ in range(WARM_CALLS):
        entry.solve(entry.feed(gen)[1])
    sync(device)
    t2 = time.perf_counter()
    setup_s = t2 - t_start
    phases = {"pool": t1 - t0, "warm call": t2 - t1}

    problems, outputs = [], []

    def keep(p, out):
        problems.append(p)
        outputs.append(out)

    window = spec.loop(wl.get("loop", "closed")).run(entry, seconds, gen,
                                                     lambda: sync(device), keep)
    n_window = len(problems)
    attempted = n_window * entry.n_batch
    failed = int(sum(int(entry.failed(o).sum()) for o in outputs))

    traced, work = None, []
    if trace:
        traced, work = trace_lib.traced_calls(entry, TRACED_CALLS, gen, keep)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.empty_cache()

    # the comparison: a sample, drawn from the seed, of every call's problems
    check = wl["check"]
    picked, got = sample(problems, outputs, check["sample"], seed, device)
    want = reference(entry, picked, check["chunk"])
    correct, checks = compare.judge(compare.numbers(got, want), check["limits"])

    run = types.SimpleNamespace(
        cell=name, solves=attempted, calls=n_window, setup_s=setup_s, setup_phases=phases,
        n_batch=entry.n_batch, trace=traced, work=work,
        port_kernels=trace_lib.port_kernel_names(spec.ROOT), **window)
    end_to_end, per_layer = spec.cell_metrics(bench, name)
    metrics = {}
    for m in (per_layer if trace else end_to_end):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else torch.device(device).type,
                         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    return result, checks, run
