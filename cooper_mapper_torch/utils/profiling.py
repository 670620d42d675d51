"""Per-stage timing, and the program's spans and counters (port of
``cooper_mapper_tpu/utils/profiling.py``, which has the timers and the trace).

* ``StageTimer``: named wall-clock accumulators with call counts, the
  reference's destructor counters as an explicit report.  Each stage is
  also a span.
* ``tracing``: turns the program's spans and counters on for a block and
  yields the ``Trace`` that keeps them in memory.  Off by default.
* ``span``: a named host interval of the program (a solve, a refresh
  block, one GN iteration's residuals, ...).  Each is also entered as a
  ``torch.profiler.record_function`` range, so under a profiler session it
  sits on the same timeline as the card's kernels.
* ``count``: a count made where the work happens (valid points, matched
  rows, lane-steps), added to the innermost open span; tensors are reduced
  on the device and read with one synchronize by ``Trace.counters()``.
* ``tally`` and ``COUNTS``: host-int counters kept always: the kernels'
  launches and merges (``races.nn1.launches``, ``knn.knn.merges``, ...).
* ``trace``: a ``torch.profiler`` trace of a block (host ops and, on the
  card, every kernel) with tracing on, written as a Chrome trace: the
  counterpart of the JAX package's ``xla_trace``.

A stage given ``sync`` (a device) waits for that device's queued work
before it stops the clock, so a stage's device time is counted in it and
not in the next stage that reads a result; the JAX package blocks on the
stage's output for the same reason.  On the CPU there is nothing to wait
for.

Spans and counters serve one thread: the spans open on the host nest.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

# The clock of a span's host times: the one torch.profiler stamps host
# events with.  torch converts its host timestamps to nanoseconds since the
# Unix epoch (c10's ApproximateClockToUnixTimeConverter, calibrated against
# CLOCK_REALTIME on Linux); tests/test_torch_tracing.py holds the two equal.
clock_ns = time.time_ns

# host-int counters kept whether tracing is on or off: the kernels' launches
# and the searches that split M and so launched a merge too
COUNTS: collections.Counter = collections.Counter()

_TRACE: Optional["Trace"] = None      # the open tracing() block's Trace; None: off
_NULL = contextlib.nullcontext()


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span: ``call`` is the id of the solve call (the root span) it
    belongs to; host times in ``clock_ns`` nanoseconds.  ``counts`` holds
    the counters added while it was the innermost open span (tensor counts
    once ``Trace.counters()`` has read them)."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: Optional[int] = None
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class Trace:
    """The spans and counters of one ``tracing()`` block, in memory."""

    def __init__(self) -> None:
        self.spans: List[SpanRecord] = []
        self.loose: Dict[str, int] = {}   # counters added outside every span
        self._open: List[SpanRecord] = []
        self._pending: list = []          # (record or None, name, 0-d tensor)
        self._ids = itertools.count(1)

    def _enter(self, name: str, call: bool) -> SpanRecord:
        parent = self._open[-1] if self._open else None
        sid = next(self._ids)
        rec = SpanRecord(name, sid, parent.id if parent else None,
                         sid if call or parent is None else parent.call, clock_ns())
        self.spans.append(rec)
        self._open.append(rec)
        return rec

    def _exit(self, rec: SpanRecord) -> None:
        rec.end_ns = clock_ns()
        self._open.pop()

    def _count(self, name: str, value) -> None:
        rec = self._open[-1] if self._open else None
        if isinstance(value, torch.Tensor):
            self._pending.append((rec, name, value.sum(dtype=torch.int64)))
            return
        into = rec.counts if rec is not None else self.loose
        into[name] = into.get(name, 0) + int(value)

    def counters(self) -> Dict[str, Dict[str, int]]:
        """Every counter, summed by span name (``""``: outside every span):
        {span name: {counter: total}}.  Reads the tensor counts with one
        synchronize per device that holds any, and stores each span's own in
        its ``counts``."""
        by_device = defaultdict(list)
        for item in self._pending:
            by_device[item[2].device].append(item)
        for items in by_device.values():
            for (rec, name, _), v in zip(items, torch.stack([t for *_, t in items]).tolist()):
                into = rec.counts if rec is not None else self.loose
                into[name] = into.get(name, 0) + v
        self._pending.clear()
        total: Dict[str, Dict[str, int]] = defaultdict(dict)
        for key, counts in [("", self.loose)] + [(r.name, r.counts) for r in self.spans]:
            for name, v in counts.items():
                total[key][name] = total[key].get(name, 0) + v
        return dict(total)

    def self_ns(self) -> Dict[int, int]:
        """Each closed span's self time: its duration less what its child
        spans cover (children nest inside their parent and do not overlap),
        {span id: ns}."""
        own = {r.id: r.end_ns - r.start_ns for r in self.spans if r.end_ns is not None}
        for r in self.spans:
            if r.parent in own and r.end_ns is not None:
                own[r.parent] -= r.end_ns - r.start_ns
        return own


class _Span:
    __slots__ = ("trace", "name", "call", "range", "rec")

    def __init__(self, trace: Trace, name: str, call: bool) -> None:
        self.trace, self.name, self.call = trace, name, call

    def __enter__(self) -> SpanRecord:
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.rec = self.trace._enter(self.name, self.call)
        return self.rec

    def __exit__(self, *exc) -> bool:
        self.trace._exit(self.rec)
        self.range.__exit__(*exc)
        return False


def span(name: str, call: bool = False):
    """A context manager that records span ``name`` while tracing is on;
    ``call=True`` marks a solve call's root span (its id is the call id of
    every span inside it).  With tracing off: one shared null context."""
    if _TRACE is None:
        return _NULL
    return _Span(_TRACE, name, call)


def enabled() -> bool:
    """True inside a ``tracing()`` block: for counts whose tensors are worth
    forming only when something reads them."""
    return _TRACE is not None


def count(name: str, value) -> None:
    """Add ``value`` (a Python int, or a tensor: a bool mask or per-lane
    counts, summed on its device without a synchronize) to counter ``name``
    of the innermost open span.  With tracing off: nothing, no kernel."""
    if _TRACE is None:
        return
    _TRACE._count(name, value)


def tally(name: str, n: int = 1) -> None:
    """Add ``n`` to host counter ``name`` of ``COUNTS`` (always) and, with
    tracing on, to the innermost open span."""
    COUNTS[name] += int(n)
    if _TRACE is not None and n:
        _TRACE._count(name, int(n))


@contextlib.contextmanager
def tracing() -> Iterator[Trace]:
    """Turn the program's spans and counters on for the block; yields the
    ``Trace`` that keeps them.  Inside an open block, yields that block's."""
    global _TRACE
    if _TRACE is not None:
        yield _TRACE
        return
    _TRACE = Trace()
    try:
        yield _TRACE
    finally:
        _TRACE = None


class StageTimer:
    """Accumulates wall time and call counts per named pipeline stage."""

    def __init__(self) -> None:
        self.total_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.first_s: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        """Time a block (a span ``name`` with tracing on); with ``sync`` (a
        device) wait for its work first."""
        with span(name):
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
def trace(log_dir: str) -> Iterator[Trace]:
    """Trace the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where a card is present) with the program's spans on, and write it
    to ``log_dir/trace_<pid>_<n>.json`` (Chrome trace format; open it in
    chrome://tracing or Perfetto): the spans sit over the kernels.  Yields
    the block's ``Trace``.  The counterpart of the JAX package's
    ``xla_trace``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing() as tr, profile(activities=activities) as prof:
        yield tr
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
