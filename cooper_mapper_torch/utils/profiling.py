"""Per-stage timing (port of ``cooper_mapper_tpu/utils/profiling.py``).

* ``StageTimer``: named wall-clock accumulators with call counts, the
  reference's destructor counters as an explicit report.
* ``time_stage``: a standalone stage timer.
* ``trace``: a ``torch.profiler`` trace of a block (host ops and, on the
  card, every kernel), written as a Chrome trace: the counterpart of the
  JAX package's ``xla_trace``.

A stage given ``sync`` (a device) waits for that device's queued work
before it stops the clock, so a stage's device time is counted in it and
not in the next stage that reads a result; the JAX package blocks on the
stage's output for the same reason.  On the CPU there is nothing to wait
for.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates wall time and call counts per named pipeline stage."""

    def __init__(self) -> None:
        self.total_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.first_s: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        """Time a block; with ``sync`` (a device) wait for its work first."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            dt = time.perf_counter() - t0
            self.total_s[name] += dt
            self.calls[name] += 1
            self.first_s.setdefault(name, dt)

    def report(self) -> str:
        """The reference's destructor-counter printout, on demand.
        ``steady`` leaves out each stage's first call, which pays the
        first-use costs (kernel build and load, allocator growth)."""
        lines = []
        for name in sorted(self.total_s, key=self.total_s.get, reverse=True):
            n = self.calls[name]
            tot = self.total_s[name]
            line = (f"{name:<28s} {n:6d} calls  {tot * 1e3:10.1f} ms total"
                    f"  {tot / max(n, 1) * 1e3:8.2f} ms/call")
            if n > 1:
                steady = (tot - self.first_s[name]) / (n - 1)
                line += f"  {steady * 1e3:8.2f} ms/call steady"
            lines.append(line)
        return "\n".join(lines)

    def reset(self) -> None:
        self.total_s.clear()
        self.calls.clear()
        self.first_s.clear()


@contextlib.contextmanager
def time_stage(name: str, timer: Optional[StageTimer] = None) -> Iterator[None]:
    """Standalone stage timer: prints when no StageTimer is given."""
    if timer is not None:
        with timer.stage(name):
            yield
        return
    t0 = time.perf_counter()
    yield
    print(f"[{name}] {(time.perf_counter() - t0) * 1e3:.1f} ms")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where a card is present) and write it to
    ``log_dir/trace_<pid>_<n>.json`` (Chrome trace format; open it in
    chrome://tracing or Perfetto).  The counterpart of the JAX package's
    ``xla_trace``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
