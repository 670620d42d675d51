"""Where the time of the port's batched odometry solve goes, on one NVIDIA card.

    python3 profile_torch_solve.py        # from the repository root; needs one CUDA card

Builds the problem of ``chip_smoke.py`` (B = 512 lanes of the bench sweep
pair, default ``OdometryConfig``), runs one warm-up batch solve, then
traces ``--solves`` batch solves with ``torch.profiler`` (CPU and CUDA
activities) and prints:

* wall time per batch solve (host clock around ``torch.cuda.synchronize()``),
  device busy time per batch solve and the device's idle share;
* CUDA kernels launched per batch solve;
* device time by kernel, the largest first, with the race kernels' own
  (wrapper-free) time per launch.

``--trace PATH`` also writes the chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", help="write the chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_solve: no CUDA device")

    import chip_smoke as cs
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry

    name = torch.cuda.get_device_name(0)
    smi = cs.card_line()[1]
    sharp1, flat1, ref_c, ref_s, _ = cs.make_problem("cuda")
    sharp, flat = cs.tile(sharp1, cs.BATCH), cs.tile(flat1, cs.BATCH)
    rng = np.random.RandomState(0)
    x0s = [torch.from_numpy((0.02 * rng.randn(cs.BATCH, 6)).astype(np.float32)).cuda()
           for _ in range(args.solves + 1)]
    cfg = OdometryConfig()
    odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0s[0], cfg)   # build + warm-up
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for x0 in x0s[1:]:
            odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.solves

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels) / args.solves
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"per batch solve (B={cs.BATCH}): wall {wall * 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}, "
          f"{len(kernels) / args.solves:.0f} device activities", flush=True)
    print(f"{'device ms/solve':>15} {'launches/solve':>14} {'us/launch':>10}  kernel")
    for kname, (t, n) in rows[:args.top]:
        print(f"{t / args.solves / 1e3:15.3f} {n / args.solves:14.0f} {t / n:10.2f}  {kname[:90]}")
    races = {k: (t / n, n / args.solves) for k, (t, n) in by_name.items()
             if any(r in k for r in ("nn1_kernel", "masked_kernel", "bc_races_kernel"))}
    race_us = sum(us * n for us, n in races.values())
    print(f"race kernels: {race_us / 1e3:.3f} ms/solve "
          f"({race_us / busy_us:.3f} of device busy time)", flush=True)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": name, "power": smi, "batch": cs.BATCH, "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3, "idle_share": 1 - busy_us / 1e6 / wall,
        "activities_per_solve": len(kernels) / args.solves,
        "race_kernel_us_per_launch": {k: v[0] for k, v in races.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
