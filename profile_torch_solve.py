"""Where the time of the port's solves and single-stream sweeps goes, on one
NVIDIA card.

    python3 profile_torch_solve.py        # from the repository root; needs one CUDA card

Profiles the three paths of ``chip_smoke.py`` on their problems:

* odometry: ``batch_odometry_solve``, B = 512 lanes of the bench sweep pair,
  default ``OdometryConfig``;
* scan-to-map: ``batch_scan_match``, B = 64 frames against the shared
  surround map of ``benchmarks/bench_scan_match.py``, default
  ``ScanMatchConfig``;
* single stream: the drive of ``benchmarks/bench_realtime.py`` at the
  default ``PipelineConfig``: ``init_sweep`` and sweeps 1-4 as warm-up, then
  one ``odometry_sweep`` (sweep 5) and one ``mapping_sweep`` (sweep 6)
  traced, on the split route and with ``COOPER_PALLAS_FUSED=1``.

For the batch solves: one warm-up batch solve, then ``--solves`` batch
solves traced with ``torch.profiler`` (CPU and CUDA activities).  For each
path it prints

* wall time per batch solve (host clock around ``torch.cuda.synchronize()``),
  device busy time per batch solve and the device's idle share;
* CUDA kernels launched per batch solve;
* device time by kernel, the largest first, with the port's own kernels'
  (wrapper-free) time per launch;
* host and device time of its stages, the program's own spans
  (``utils/profiling.tracing``, on for the whole run): a kernel counts for
  the innermost stage whose range holds its start on the device timeline;
  the rest is "other".  Odometry: the refresh blocks' searches, the GN
  iterations' residuals, normal equations and update.  Scan-to-map: the
  k-NN searches, the line and plane fits, the residuals, the normal
  equations, the update and the score gate's build.  Single stream: feature
  extraction, the odometry solve, the frame's voxel filter, the map's
  recentre and surround gather, the scan-to-map solve and the insert.

``--trace DIR`` also writes each path's chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# the port's own kernels, with the merges of a search split across blocks
RACES = ("nn1_kernel", "masked_kernel", "bc_races_kernel", "fused_races_kernel", "merge_min")
KNN = ("knn_kernel", "merge_first_k")
KERNEL_NAMES = {"odometry": RACES, "scan_match": KNN, "stream": RACES + KNN}
GN_STAGES = ("gn.residuals", "gn.normal_eqs", "gn.update")
ODO_STAGES = ("odometry.refresh",) + GN_STAGES
SM_STAGES = ("scan_match.search", "scan_match.fit") + GN_STAGES + ("scan_match.score",)
STREAM_STAGES = ("features.extract", "odometry.solve", "mapping.prepare_frame",
                 "mapping.recenter", "mapping.surround", "scan_match.solve", "mapping.insert")


def profile(label, calls, batch, top, trace_dir, trace, stages=(), kind=None):
    """Trace each of ``calls`` (zero-argument callables; the caller warms up);
    ``trace`` is the open ``profiling.tracing()`` block's, whose span names
    are ranges, not device work."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = len(calls)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n

    # device activities, less the device-side ranges of the program's spans
    ranges = {r.name for r in trace.spans} | set(stages)
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev_events if e.name not in ranges]
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in dev_events if e.name in stages]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / n
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"[{label}] per call (B={batch}): wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}, "
          f"{len(kernels) / n:.0f} device activities", flush=True)
    print(f"{'device ms/call':>15} {'launches/call':>14} {'us/launch':>10}  kernel")
    for kname, (t, c) in rows[:top]:
        print(f"{t / n / 1e3:15.3f} {c / n:14.0f} {t / c:10.2f}  {kname[:90]}")
    own = {k: (t / c, c / n) for k, (t, c) in by_name.items()
           if any(r in k for r in KERNEL_NAMES[kind or label])}
    own_us = sum(us * c for us, c in own.values())
    print(f"[{label}] the port's kernels: {own_us / 1e3:.3f} ms/call "
          f"({own_us / busy_us:.3f} of device busy time)", flush=True)
    by_stage = {}
    if spans:
        dev_us = dict.fromkeys(tuple(stages) + ("other",), 0.0)
        for e in kernels:
            holding = [(a, nm) for nm, a, b in spans if a <= e.time_range.start < b]
            dev_us[max(holding)[1] if holding else "other"] += e.time_range.elapsed_us()
        host_us = {e.key: (e.count, e.cpu_time_total) for e in prof.key_averages()
                   if e.key in stages and e.cpu_time_total > 0}   # the host-side ranges
        for stage, us in dev_us.items():
            count, host = host_us.get(stage, (0, float("nan")))
            by_stage[stage] = {"calls_per_call": count / n, "host_ms_per_call": host / n / 1e3,
                               "device_ms_per_call": us / n / 1e3}
            print(f"[{label}] stage {stage}: {by_stage[stage]}", flush=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
    return {"batch": batch, "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "activities_per_call": len(kernels) / n,
            "kernel_us_per_launch": {k: v[0] for k, v in own.items()},
            "kernel_launches_per_call": {k: v[1] for k, v in own.items()},
            "stages": by_stage}


def profile_stream(cs, top, trace_dir, trace):
    """One odometry and one mapping sweep of the single-stream drive, traced
    after sweeps 0-4, on each route."""
    from cooper_mapper_torch.models import fused

    cfg, sweeps, _, _ = cs.make_stream("cuda")
    out = {}
    for route in ("split", "fused"):
        os.environ["COOPER_PALLAS_FUSED"] = "1" if route == "fused" else "0"
        st = fused.init_sweep(fused.create(cfg), sweeps[0], cfg)
        for i in range(1, 5):
            step = fused.mapping_sweep if i % 2 == 0 else fused.odometry_sweep
            st = step(st, sweeps[i], cfg)[0]
        box = [st]
        run = lambda step, i: box.__setitem__(0, step(box[0], sweeps[i], cfg)[0])
        out[route] = {
            "odometry_sweep": profile(f"stream {route} odometry_sweep",
                                      [lambda: run(fused.odometry_sweep, 5)], 1, top, trace_dir,
                                      trace, STREAM_STAGES, "stream"),
            "mapping_sweep": profile(f"stream {route} mapping_sweep",
                                     [lambda: run(fused.mapping_sweep, 6)], 1, top, trace_dir,
                                     trace, STREAM_STAGES, "stream")}
    os.environ["COOPER_PALLAS_FUSED"] = "0"
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="write the chrome traces to this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_solve: no CUDA device")
    os.environ["COOPER_PALLAS_FUSED"] = "0"

    import chip_smoke as cs
    from cooper_mapper_torch.config import OdometryConfig, ScanMatchConfig
    from cooper_mapper_torch.ops import odometry
    from cooper_mapper_torch.ops import scan_match as sm
    from cooper_mapper_torch.utils import profiling

    name = torch.cuda.get_device_name(0)
    smi = cs.card_line()[1]
    rng = np.random.RandomState(0)
    priors = lambda b: [torch.from_numpy((0.02 * rng.randn(b, 6)).astype(np.float32)).cuda()
                        for _ in range(args.solves + 1)]
    out = {"device": name, "power": smi}

    with profiling.tracing() as tr:
        sharp1, flat1, ref_c, ref_s, _ = cs.make_problem("cuda")
        sharp, flat = cs.tile(sharp1, cs.BATCH), cs.tile(flat1, cs.BATCH)
        cfg = OdometryConfig()
        solve = lambda x0: odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0, cfg)
        x0s = priors(cs.BATCH)
        solve(x0s[0])
        out["odometry"] = profile("odometry", [lambda x0=x0: solve(x0) for x0 in x0s[1:]],
                                  cs.BATCH, args.top, args.trace, tr, ODO_STAGES)

        corner1, surf1, map_c, map_s = cs.make_scan_match_problem("cuda")
        corner, surf = cs.tile(corner1, cs.SM_BATCH), cs.tile(surf1, cs.SM_BATCH)
        sm_cfg = ScanMatchConfig()
        solve = lambda x0: sm.batch_scan_match(corner, surf, map_c, map_s, x0, sm_cfg)
        x0s = priors(cs.SM_BATCH)
        solve(x0s[0])
        out["scan_match"] = profile("scan_match", [lambda x0=x0: solve(x0) for x0 in x0s[1:]],
                                    cs.SM_BATCH, args.top, args.trace, tr, SM_STAGES)
        out["stream"] = profile_stream(cs, args.top, args.trace, tr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
