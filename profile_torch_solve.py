"""Where the time of the port's batched solves goes, on one NVIDIA card.

    python3 profile_torch_solve.py        # from the repository root; needs one CUDA card

Profiles the two paths of ``chip_smoke.py`` on their problems:

* odometry: ``batch_odometry_solve``, B = 512 lanes of the bench sweep pair,
  default ``OdometryConfig``;
* scan-to-map: ``batch_scan_match``, B = 64 frames against the shared
  surround map of ``benchmarks/bench_scan_match.py``, default
  ``ScanMatchConfig``.

For each: one warm-up batch solve, then ``--solves`` batch solves traced
with ``torch.profiler`` (CPU and CUDA activities), and prints

* wall time per batch solve (host clock around ``torch.cuda.synchronize()``),
  device busy time per batch solve and the device's idle share;
* CUDA kernels launched per batch solve;
* device time by kernel, the largest first, with the port's own kernels'
  (wrapper-free) time per launch;
* for the scan-to-map path, host and device time of its two stages, the
  residual build (k-NN, fits, coefficients, Jacobian) and the GN step
  (projector, 6x6 solve, update), from ``record_function`` ranges that this
  script wraps around them: a kernel counts for a stage when it starts
  inside that range's span on the device timeline; the rest (normal
  equations, the final score) is "other".

``--trace DIR`` also writes each path's chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

KERNEL_NAMES = {"odometry": ("nn1_kernel", "masked_kernel", "bc_races_kernel"),
                "scan_match": ("knn_kernel",)}
STAGES = ("residual_build", "gn_step")


def profile(label, solve, x0s, batch, top, trace_dir):
    """Trace solve(x0) for each of x0s[1:] after a warm-up with x0s[0]."""
    solve(x0s[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = len(x0s) - 1
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for x0 in x0s[1:]:
            solve(x0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n

    # device activities, less the device-side spans of the stage ranges
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev_events if e.name not in STAGES]
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in dev_events if e.name in STAGES]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / n
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"[{label}] per batch solve (B={batch}): wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}, "
          f"{len(kernels) / n:.0f} device activities", flush=True)
    print(f"{'device ms/solve':>15} {'launches/solve':>14} {'us/launch':>10}  kernel")
    for kname, (t, c) in rows[:top]:
        print(f"{t / n / 1e3:15.3f} {c / n:14.0f} {t / c:10.2f}  {kname[:90]}")
    own = {k: (t / c, c / n) for k, (t, c) in by_name.items()
           if any(r in k for r in KERNEL_NAMES[label])}
    own_us = sum(us * c for us, c in own.values())
    print(f"[{label}] the port's kernels: {own_us / 1e3:.3f} ms/solve "
          f"({own_us / busy_us:.3f} of device busy time)", flush=True)
    stages = {}
    if spans:
        dev_us = dict.fromkeys(STAGES + ("other",), 0.0)
        for e in kernels:
            stage = next((nm for nm, a, b in spans if a <= e.time_range.start < b), "other")
            dev_us[stage] += e.time_range.elapsed_us()
        host_us = {e.key: (e.count, e.cpu_time_total) for e in prof.key_averages()
                   if e.key in STAGES and e.cpu_time_total > 0}   # the host-side ranges
        for stage, us in dev_us.items():
            count, host = host_us.get(stage, (0, float("nan")))
            stages[stage] = {"calls_per_solve": count / n, "host_ms_per_solve": host / n / 1e3,
                             "device_ms_per_solve": us / n / 1e3}
            print(f"[{label}] stage {stage}: {stages[stage]}", flush=True)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.json"))
    return {"batch": batch, "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "activities_per_solve": len(kernels) / n,
            "kernel_us_per_launch": {k: v[0] for k, v in own.items()},
            "kernel_launches_per_solve": {k: v[1] for k, v in own.items()},
            "stages": stages}


def _ranged(name, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="write the chrome traces to this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_solve: no CUDA device")

    import chip_smoke as cs
    from cooper_mapper_torch.config import OdometryConfig, ScanMatchConfig
    from cooper_mapper_torch.ops import odometry
    from cooper_mapper_torch.ops import scan_match as sm

    name = torch.cuda.get_device_name(0)
    smi = cs.card_line()[1]
    rng = np.random.RandomState(0)
    priors = lambda b: [torch.from_numpy((0.02 * rng.randn(b, 6)).astype(np.float32)).cuda()
                        for _ in range(args.solves + 1)]
    out = {"device": name, "power": smi}

    sharp1, flat1, ref_c, ref_s, _ = cs.make_problem("cuda")
    sharp, flat = cs.tile(sharp1, cs.BATCH), cs.tile(flat1, cs.BATCH)
    cfg = OdometryConfig()
    out["odometry"] = profile(
        "odometry", lambda x0: odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0, cfg),
        priors(cs.BATCH), cs.BATCH, args.top, args.trace)

    corner1, surf1, map_c, map_s = cs.make_scan_match_problem("cuda")
    corner, surf = cs.tile(corner1, cs.SM_BATCH), cs.tile(surf1, cs.SM_BATCH)
    sm_cfg = ScanMatchConfig()
    # stage ranges for this trace only: the package itself carries no instrumentation
    sm._build_residuals = _ranged("residual_build", sm._build_residuals)
    sm.gn.gn_step = _ranged("gn_step", sm.gn.gn_step)
    out["scan_match"] = profile(
        "scan_match", lambda x0: sm.batch_scan_match(corner, surf, map_c, map_s, x0, sm_cfg),
        priors(cs.SM_BATCH), cs.SM_BATCH, args.top, args.trace)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
