"""Device times of the k-NN and bc_races kernels at the main paths' shapes,
for one checkout of the port at a time, on one NVIDIA card.

    python3 time_search_kernels.py --save-inputs FILE
    python3 time_search_kernels.py --inputs FILE [--root DIR] [--label NAME]

``--save-inputs`` builds the searches' inputs on the card with
``chip_smoke.py``'s problem builders and saves them:

* k-NN 64x2048 vs 5888 and 64x256 vs 512: the scan-to-map batch solve's
  surf and corner searches at its first residual build (phase 6); and the
  surf search again against the same map in a random order of its points
  (the kernel's sampled bound pays off only on a reference stored in
  spatial order);
* k-NN 1x8192 vs 65536 and 1x2048 vs 32768: sweep 4's mapping searches in
  the single-stream drive (phase 10);
* bc_races 512x768 vs 3840: the odometry batch solve's surf races at its
  first correspondence refresh (phase 3);
* bc_races 1x1024 vs 8192: the single-stream drive's first surf search
  (phase 8).

The second form imports ``cooper_mapper_torch`` from ``--root`` (default:
this checkout), so that two commits can be timed on the same inputs, in
turns, on one card (parent, change, change, parent).  For each search it
checks the kernel against its plain version, bit for bit, then prints one
JSON line with, per search: the wrapper's ms per call (CUDA events over 20
calls after 2 warm-ups, as ``chip_smoke.py`` times them); the device ms per
call of the port's own kernels in it (``torch.profiler`` over 20 calls, as
``profile_torch_solve.py`` reports them), with their launches per call; the
bound (``chip_smoke.py``'s pairs x FP32 operations per pair over the non-FMA
FP32 rate); the card's name and power limit.  A design variant is timed the
same way: edit its constant in a copy of the checkout and pass ``--root``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

REPS = 20
# the port's own kernels, by the names the profiler shows (a name contains one)
OWN_KERNELS = ("knn_kernel", "bc_races_kernel", "merge_first_k", "merge_min")


def save_inputs(path):
    from cooper_mapper_torch.utils import twist

    dev = "cuda"
    out = {}
    ref = lambda c: {"xyz": c.xyz, "mask": c.mask, "ring": c.ring}

    # scan-to-map batch (phase 6): frames registered at the priors
    corner, surf, map_c, map_s = cs.make_scan_match_problem(dev)
    x0 = torch.from_numpy((0.02 * np.random.RandomState(0).randn(cs.SM_BATCH, 6))
                          .astype(np.float32)).to(dev)
    out["knn 64x2048 vs 5888"] = dict(kind="knn", q=twist.point_to_map(x0, surf.xyz),
                                      **ref(map_s))
    perm = torch.from_numpy(np.random.RandomState(0).permutation(map_s.xyz.shape[0])).to(dev)
    out["knn 64x2048 vs 5888 (map in random order)"] = dict(
        kind="knn", q=out["knn 64x2048 vs 5888"]["q"], xyz=map_s.xyz[perm].contiguous(),
        mask=map_s.mask[perm].contiguous(), ring=map_s.ring[perm].contiguous())
    out["knn 64x256 vs 512"] = dict(kind="knn", q=twist.point_to_map(x0, corner.xyz),
                                    **ref(map_c))

    # single stream: sweep 4's mapping searches (phase 10), first surf search (phase 8)
    cfg, sweeps, _, clouds = cs.make_stream(dev)
    for tag, (q, _, sur) in cs.mapping_knn_inputs(cfg, sweeps, dev).items():
        out[f"knn 1x{q.shape[1]} vs {sur.xyz.shape[0]} ({tag})"] = dict(kind="knn", q=q,
                                                                       **ref(sur))
    fq, s_ref = clouds[1], clouds[3]
    ra, ia = cs.race_a_ring(fq, s_ref)
    out["bc_races 1x1024 vs 8192"] = dict(kind="bc_races", q=fq, ra=ra, ia=ia, **ref(s_ref))

    # odometry batch (phase 3): the de-warped surf queries of the first refresh
    _, flat1, _, ref_s, _ = cs.make_problem(dev)
    flat = cs.tile(flat1, cs.BATCH)
    xb = torch.from_numpy((0.02 * np.random.RandomState(0).randn(cs.BATCH, 6))
                          .astype(np.float32)).to(dev)
    qs = twist.warp_to_start(xb, flat.xyz, flat.rel_time).contiguous()
    ra, ia = cs.race_a_ring(qs, ref_s)
    out["bc_races 512x768 vs 3840"] = dict(kind="bc_races", q=qs, ra=ra, ia=ia, **ref(ref_s))
    torch.save({k: {n: (t.cpu() if torch.is_tensor(t) else t) for n, t in v.items()}
                for k, v in out.items()}, path)
    print(json.dumps({k: tuple(v["q"].shape) + tuple(v["xyz"].shape) for k, v in out.items()}))


def device_ms(fn):
    """(device ms per call of the port's kernels, their launches per call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and any(k in e.name for k in OWN_KERNELS)]
    return sum(e.time_range.elapsed_us() for e in ev) / REPS / 1e3, len(ev) / REPS


def time_tree(path, label):
    from cooper_mapper_torch.ops import knn, races

    data = torch.load(path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"label": label, "module": os.path.dirname(knn.__file__), "card": smi}
    for name, v in data.items():
        t = {n: (x.cuda() if torch.is_tensor(x) else x) for n, x in v.items()}
        q, r, m = t["q"], t["xyz"], t["mask"]
        if v["kind"] == "knn":
            kern = lambda: knn.knn(q, r, m, 5)
            plain = knn.knn_plain(q, r, m, 5)
        else:
            args = (q, t["ra"], t["ia"], r, t["ring"], m, 2.5)
            kern = lambda: races.bc_races(*args)
            plain = races.bc_races_plain(*args)
        got = kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, plain)):
            raise SystemExit(f"time_search_kernels FAILED: {name} differs from its plain version")
        B, Q, _ = q.shape
        pairs = B * Q * r.shape[-2]
        dms, launches = device_ms(kern)
        res[name] = {"wrapper_ms": cs.time_ms(kern, REPS), "device_ms": dms,
                     "kernel_launches_per_call": launches,
                     "bound_ms": pairs * cs.OPS_PER_PAIR[v["kind"]] / cs.FP32_PEAK_OPS * 1e3}
        print(f"{label} {name}: {res[name]}", flush=True)
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save-inputs")
    ap.add_argument("--inputs")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_search_kernels: no CUDA device")
    if args.save_inputs:
        import cooper_mapper_torch  # noqa: F401  (TF32 off)
        save_inputs(args.save_inputs)
        return
    sys.path.insert(0, os.path.abspath(args.root))
    import cooper_mapper_torch  # noqa: F401

    time_tree(args.inputs, args.label)


if __name__ == "__main__":
    main()
