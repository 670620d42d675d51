"""The traced part of a ``--trace 1`` run: a few of the window's calls under
``torch.profiler``, reduced to what the per-layer metrics read.

Each call is wrapped in a ``portbench.call`` range and synchronised before
and after, so every device activity that runs inside a call's range belongs
to that call.  The reduction keeps, per call, the device activities (name,
seconds), and for the traced window the union of the device's busy time,
the device operations that took the most time and the longest idle gaps by
the host operation that was running when the device went idle.
"""

from __future__ import annotations

import bisect
import glob
import os
import re
import time

import torch

CALL_RANGE = "portbench.call"
_GLOBAL = re.compile(r"__global__\s+(?:__launch_bounds__\([^)]*\)\s*)?void\s+"
                     r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernel_names(root: str) -> tuple:
    """The names of the program's own CUDA kernels: the ``__global__``
    functions of ``cooper_mapper_torch/csrc``."""
    names = set()
    for path in glob.glob(os.path.join(root, "cooper_mapper_torch", "csrc", "*.cu*")):
        with open(path) as f:
            src = f.read()
        names.update(m.group(1) for m in _GLOBAL.finditer(src))
    return tuple(sorted(names))


def _union_s(intervals):
    """Seconds covered by the union of (start, end) microsecond intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def traced_calls(entry, n_calls: int, gen, keep):
    """Run ``n_calls`` calls of ``entry`` under the profiler; ``keep(problems,
    out)`` stores each call's answers as the window does.  Returns the
    traced window's reduction (see the module docstring) and each call's
    roofline work (``entry.bound_s``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    work = []
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            problems, args = entry.feed(gen)
            work.append(entry.bound_s(args))
            torch.cuda.synchronize()
            with torch.profiler.record_function(CALL_RANGE):
                out = entry.solve(args)
                torch.cuda.synchronize()
            keep(problems, out)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    acts_dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != CALL_RANGE]
    # each call's host range; a synchronize before and after it keeps every
    # device activity of the call inside it and every other one out
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU and e.name == CALL_RANGE)
    calls = [[] for _ in spans]
    for e in acts_dev:
        s = e.time_range.start
        for k, (a, b) in enumerate(spans):
            if a <= s <= b:
                calls[k].append((e.name, e.time_range.elapsed_us() * 1e-6))
                break
    busy = [(e.time_range.start, e.time_range.end) for e in acts_dev]
    by_name = {}
    for e in acts_dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": _union_s(busy), "calls": calls,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": _idle_gaps(events, busy)}}, work


def _outermost(e):
    while e.cpu_parent is not None and e.cpu_parent.name != CALL_RANGE:
        e = e.cpu_parent
    return e


def _idle_gaps(events, busy, top: int = 10):
    """The device's idle gaps summed by the outermost host operation that
    had started last when each gap began: [[name, seconds], ...]."""
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name != CALL_RANGE), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps, end = [], None
    for a, b in sorted(busy):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    by_name = {}
    for a, b in gaps:
        k = bisect.bisect_right(starts, a) - 1
        name = _outermost(host[k]).name if k >= 0 else "(before the first host operation)"
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
