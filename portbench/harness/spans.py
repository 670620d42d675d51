"""The span pass of a ``--trace 1`` run: where each call's device time and
idle time go, by the program's own spans, and the counts the program makes
where the work happens (``cooper_mapper_torch/utils/profiling.py``).

The pass runs once per run, after the run's traced calls and its
comparison, memoized on the run record (``of``).  It makes the cell's entry
from its files at ``SEED`` (so its answers join no comparison, and the
run's memory peak and its other readings are taken before it), makes one
warm call with tracing on, then on one call's arguments six calls with
tracing off, on, on, off, off, on (the on-cost, and whether the answers
are bit-identical), then
``CALLS`` calls under ``torch.profiler`` inside ``profiling.tracing()``,
each with a synchronize before and after.  The profiled calls are reduced
on the profiler's one clock (``reduce``):

* device busy ms per span name: each device activity goes to the
  innermost program span open on the host when the runtime call that
  launched it (the host event of the same correlation id) began;
* idle ms per span name: each gap between a call's device activities goes
  to the innermost program span open on the host when the gap began;
* spans per call and host self ms per span name (a span's duration less
  what its child spans cover), and the ``Trace``'s counters.

The device-side ranges that the profiler records for the spans' own
``record_function`` ranges (user annotations) are never counted as
activities.  The pass prints a table per span to standard error.  It gives
None, as do its readers, off a CUDA card and where the program has no
``profiling.tracing`` (a checkout before it had spans).
"""

from __future__ import annotations

import bisect
import statistics
import sys
import time
from collections import defaultdict

from ..inputs import pool as pool_lib
from . import spec

SEED = 1_907_348_251          # the pass's pool and draws; never the run's seed
CALL_STREAM = 1               # as the window's calls draw (harness/cell.py)
CALLS = 3
OUTSIDE = "(outside the spans)"
GN = ("gn.residuals", "gn.normal_eqs", "gn.update")


def of(run):
    """The span pass of ``run.cell`` (memoized on ``run``), or None."""
    if not hasattr(run, "span_pass"):
        run.span_pass = _card_pass(run.cell)
    return run.span_pass


def _card_pass(cell: str):
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from cooper_mapper_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "tracing"):
        return None
    wl = spec.workload(cell)
    return measure(cell, wl, spec.config(wl["config"]), "cuda", profiling)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(entry, args, device):
    _sync(device)
    t0 = time.perf_counter()
    out = entry.solve(args)
    _sync(device)
    return out, time.perf_counter() - t0


def on_off(entry, args, device, profiling) -> dict:
    """Six calls on ``args`` with tracing off, on, on, off, off, on: their
    seconds and whether every answer equals the first bit for bit."""
    import torch

    outs, secs = [], {"off": [], "on": []}
    for mode in ("off", "on", "on", "off", "off", "on"):
        if mode == "on":
            with profiling.tracing():
                out, s = _timed(entry, args, device)
        else:
            out, s = _timed(entry, args, device)
        outs.append(out)
        secs[mode].append(s)
    same = all(torch.equal(o[k], outs[0][k]) for o in outs[1:] for k in outs[0])
    return {"off_s": secs["off"], "on_s": secs["on"], "bit_identical": same,
            "on_cost": statistics.median(secs["on"]) / statistics.median(secs["off"]) - 1.0}


def measure(cell: str, wl: dict, cfg: dict, device, profiling, calls: int = CALLS,
            out=sys.stderr) -> dict:
    """The span pass of one cell at the given files, on ``device``."""
    import torch

    entry = spec.entry(wl["entry"])(cfg, wl["traffic"], SEED, device)
    _, gen = pool_lib.generators(SEED, CALL_STREAM, device)
    with profiling.tracing():       # warms the kernels of both paths (the counters')
        entry.solve(entry.feed(gen)[1])
    cost = on_off(entry, entry.feed(gen)[1], device, profiling)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with profiling.tracing() as tr:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                args = entry.feed(gen)[1]
                _timed(entry, args, device)
        tr.counters()
    names = {r.name for r in tr.spans}
    ranges, launches, activities = from_profiler(prof.events(), names)
    result = reduce(tr.spans, tr.self_ns(), ranges, launches, activities)
    result["on_off"] = cost
    print(table(cell, result), file=out, flush=True)
    return result


def from_profiler(events, span_names) -> tuple:
    """The profiler's events as ``reduce`` takes them: the spans' host
    ranges [(name, start_us, end_us)], the runtime calls' host start by
    correlation id {id: start_us}, and the device activities
    [(name, start_us, end_us, correlation id)], user annotations left out."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges, launches, activities = [], {}, []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cpu:
            if e.name in span_names:
                ranges.append((e.name, a, b))
            elif e.name.startswith("cu"):
                launches[e.id] = a
        elif (e.device_type == cuda and e.name not in span_names
              and not getattr(e, "is_user_annotation", False)):
            activities.append((e.name, a, b, e.id))
    return ranges, launches, activities


def _timeline(intervals):
    """Change points of the innermost open interval: (times, owners) with
    ``owners[i]`` open from ``times[i]`` (None: none).  ``intervals`` are
    (start, end, key), nested or disjoint."""
    times, owners, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            top = stack.pop()
            times.append(top[1])
            owners.append(stack[-1][2] if stack else None)

    for start, end, key in sorted(intervals, key=lambda s: (s[0], -s[1])):
        close_until(start)
        stack.append((start, end, key))
        times.append(start)
        owners.append(key)
    close_until(float("inf"))
    return times, owners


def _owner(timeline, t):
    times, owners = timeline
    k = bisect.bisect_right(times, t) - 1
    return owners[k] if k >= 0 else None


def reduce(records, self_ns: dict, ranges, launches: dict, activities) -> dict:
    """Per span name, per call (a call: a root span, ``call`` = its id):
    ``count``, ``host_self_ms``, ``busy_ms``, ``idle_ms``; per call the
    counters summed by span name (``calls``); and the totals.  ``records``
    are the ``Trace``'s spans, paired in order, name by name, with the
    profiler's ``ranges`` of the same spans, whose times (the profiler's
    clock, as the activities') place them."""
    by_name = defaultdict(list)
    for name, a, b in sorted(ranges, key=lambda r: (r[1], -r[2])):
        by_name[name].append((a, b))
    placed, skew, unpaired = {}, 0.0, 0
    for r in records:
        if not by_name[r.name] or r.end_ns is None:
            unpaired += 1
            continue
        a, b = by_name[r.name].pop(0)
        placed[r.id] = (a, b)
        skew = max(skew, abs((b - a) - (r.end_ns - r.start_ns) / 1e3))
    rec = {r.id: r for r in records}
    roots = [r for r in records if r.id == r.call and r.parent is None]
    n = max(len(roots), 1)
    host = _timeline([(a, b, sid) for sid, (a, b) in placed.items()])

    busy, idle = defaultdict(float), defaultdict(float)
    per_call = defaultdict(list)
    unattributed = [0, 0.0, defaultdict(int)]
    for name, a, b, cid in activities:
        t = launches.get(cid)
        if t is None:
            unattributed[0] += 1
            unattributed[1] += b - a
            unattributed[2][name[:40]] += 1
            continue
        sid = _owner(host, t)
        busy[rec[sid].name if sid is not None else OUTSIDE] += b - a
        if sid is not None:
            per_call[rec[sid].call].append((a, b))
    for root in roots:
        end = None
        for a, b in sorted(per_call[root.id]):
            if end is not None and a > end:
                sid = _owner(host, end)
                idle[rec[sid].name if sid is not None else OUTSIDE] += a - end
            end = b if end is None else max(end, b)

    spans = defaultdict(lambda: dict.fromkeys(("count", "host_self_ms", "busy_ms",
                                               "idle_ms"), 0.0))
    for r in records:
        spans[r.name]["count"] += 1 / n
        spans[r.name]["host_self_ms"] += self_ns.get(r.id, 0) / 1e6 / n
    for by_span, key in ((busy, "busy_ms"), (idle, "idle_ms")):
        for name, us in by_span.items():
            spans[name][key] = us / 1e3 / n
    calls = {root.id: {"root": root.name, "counts": defaultdict(lambda: defaultdict(int)),
                       "spans": defaultdict(int)} for root in roots}
    for r in records:
        if r.call in calls:
            c = calls[r.call]
            c["spans"][r.name] += 1
            for k, v in r.counts.items():
                c["counts"][r.name][k] += v
    in_spans = sum(v for k, v in busy.items() if k != OUTSIDE)
    root_self = sum(busy.get(name, 0.0) for name in {r.name for r in roots})
    return {"calls": [{"root": c["root"], "spans": dict(c["spans"]),
                       "counts": {k: dict(v) for k, v in c["counts"].items()}}
                      for c in calls.values()],
            "spans": dict(spans),
            "busy_ms": in_spans / 1e3 / n,
            "root_self_busy_share": root_self / in_spans if in_spans > 0 else None,
            "unattributed": {"activities": unattributed[0] / n,
                             "ms": unattributed[1] / 1e3 / n,
                             "names": sorted(unattributed[2].items(), key=lambda kv: -kv[1])[:5]},
            "duration_gap_us": skew, "unpaired_spans": unpaired}


def table(cell: str, p: dict) -> str:
    """The pass as text: one row per span name, per call."""
    lines = [f"span pass of {cell}: {len(p['calls'])} calls (seed {SEED}), per call",
             f"{'span':<24} {'count':>7} {'host self ms':>13} {'busy ms':>10} {'idle ms':>9}"
             "  counters"]
    counts = defaultdict(lambda: defaultdict(int))
    for c in p["calls"]:
        for name, kv in c["counts"].items():
            for k, v in kv.items():
                counts[name][k] += v
    n = max(len(p["calls"]), 1)
    for name, s in sorted(p["spans"].items(), key=lambda kv: -kv[1]["busy_ms"]):
        kv = ", ".join(f"{k} {v / n:.6g}" for k, v in sorted(counts[name].items()))
        lines.append(f"{name:<24} {s['count']:7.2f} {s['host_self_ms']:13.3f} "
                     f"{s['busy_ms']:10.3f} {s['idle_ms']:9.3f}  {kv}")
    share = p["root_self_busy_share"]
    cost = p.get("on_off")
    lines.append(f"device busy {p['busy_ms']:.3f} ms per call in the spans; the roots' self "
                 f"{'-' if share is None else f'{100 * share:.3f}%'}; unattributed "
                 f"{p['unattributed']['activities']:.1f} activities, "
                 f"{p['unattributed']['ms']:.3f} ms; span durations off the profiler's by at "
                 f"most {p['duration_gap_us']:.1f} us; spans without a profiler range "
                 f"{p['unpaired_spans']}")
    if p["unattributed"]["names"]:
        lines.append(f"unattributed activities by name: {p['unattributed']['names']}")
    if cost:
        lines.append("tracing on-cost: call ms off "
                     + " / ".join(f"{s * 1e3:.2f}" for s in cost["off_s"]) + ", on "
                     + " / ".join(f"{s * 1e3:.2f}" for s in cost["on_s"])
                     + f": {100 * cost['on_cost']:+.3f}%; answers bit-identical on and off: "
                     f"{cost['bit_identical']}")
    return "\n".join(lines)


# ---- what the readers of portbench/metrics take from a pass ----------------

def _roots(p) -> set:
    return {c["root"] for c in p["calls"]}


def span_ms(run, key: str, solves: dict):
    """``key`` (``busy_ms`` / ``idle_ms``) per call summed over the span
    names that ``solves`` gives for the pass's root span name; None where
    there is no pass, or no span of them."""
    p = of(run)
    if p is None or not p["calls"]:
        return None
    names = set().union(*(solves.get(r, ()) for r in _roots(p)))
    got = [p["spans"][k][key] for k in names if k in p["spans"]]
    return sum(got) if got else None


def _call_count(c, span: str, counter: str) -> int:
    return c["counts"].get(span, {}).get(counter, 0)


def active_lane_share(run):
    """100 * lane-steps taken / (lanes * steps a lane may take), over the
    pass's calls."""
    p = of(run)
    if p is None or not p["calls"]:
        return None
    took = sum(_call_count(c, c["root"], "lane_steps") for c in p["calls"])
    may = sum(_call_count(c, c["root"], "lanes") * _call_count(c, c["root"], "steps")
              for c in p["calls"])
    return 100.0 * took / may if may > 0 else None


def match_share(run):
    """100 * rows in the normal equations / (normal-equation builds * valid
    query points), over the pass's calls."""
    p = of(run)
    if p is None or not p["calls"]:
        return None
    rows = sum(_call_count(c, "gn.normal_eqs", "rows") for c in p["calls"])
    may = sum(c["spans"].get("gn.normal_eqs", 0) * _call_count(c, c["root"], "query_points")
              for c in p["calls"])
    return 100.0 * rows / may if may > 0 else None
