"""Drive the PyTorch/H100 port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

The main path is the headline workload of ``bench.py``, ported: a VLP-16-like
sweep pair (16 rings x 1024 columns) ray-cast in ``make_room_world(seed=42)``,
feature extraction, clouds compacted to a multiple of 256 points, and
``batch_odometry_solve`` of B = 512 independent problems against one shared
reference pair, each lane from its own initial guess ``0.02 * randn(6)``,
with the default ``OdometryConfig``.  Everything runs on the card.

Phases, each announced on its own line as it starts:

1. the card's name and power limit;
2. the kernels' build (one nvcc call), with its seconds and ptxas report;
3. every race kernel against its plain PyTorch version at the main path's
   shapes: indices equal for every query inside the 25 m^2 gate (a true tie,
   distances within 1e-5 relative, is counted and must stay under 0.1% of
   queries), distances within 1e-4 relative; kernel, plain and library
   times;
4. the main path once with every launch counter at 0, then: all lanes
   finite, four lanes equal to a CPU run of the same solve (plain versions)
   within 2e-3, every kernel launched; then the steady-state solves/s;
5. ground truth: the same solve with ``cv_dewarp=False`` (the s-scaled warp
   model, the configuration of ``tests/test_odometry.py::test_recovers_motion``)
   must put every lane within 0.05 m / 0.01 rad of the simulator's motion.
   The default path's own errors are printed beside it;
6. a ``kernels`` JSON line, then the result line.

Any failed check raises, so the process exits non-zero and prints no result.
There is no CPU fallback: without a card the script stops at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, RINGS, BATCH, WORLD_SEED = 1024, 16, 512, 42
GATE = 25.0                 # OdometryConfig.nn_sq_dist_max
TIE_RTOL = 1e-5             # a true tie: two candidates' distances this close
MAX_TIE_SHARE = 1e-3        # ties allowed per race, as a share of queries
DIST_RTOL = 1e-4
CPU_LANES, CPU_TOL = 4, 2e-3   # tests/test_odometry.py's tolerance between NN paths
TRANS_TOL, ROT_TOL = 0.05, 0.01  # tests/test_odometry.py::test_recovers_motion
# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit:
# HBM3 bandwidth, and FP32 outside the tensor cores, 67 TFLOP/s counting an
# FMA as two operations.  The race kernels issue no FMA (their rounding must
# equal the plain version's), so one FP32 operation takes one issue slot and
# their peak is half that: 132 SMs x 128 lanes x 1.98 GHz.
FP32_PEAK_OPS = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# FP32 operations per (query, reference) pair: 8 for d = (|q|^2 - 2 q.r) + |r|^2
# (3 mul, 2 add, 1 scale, 1 sub, 1 add), 1 compare per running minimum, and
# the ring tests ("adj": sub, 2 compares; "same": 1 compare).  The selects
# that keep (min, argmin) are left out, so the bound is a floor.
OPS_PER_PAIR = {"nn1": 9, "nn1_masked": 12, "bc_races": 14}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[1] card: {name} | nvidia-smi: {smi}")
    return name, smi


def build_phase():
    from cooper_mapper_torch import build

    log("[2] building kernels (one nvcc call)")
    t0 = time.perf_counter()
    build.library()
    wall = time.perf_counter() - t0
    nvcc = build.build_seconds
    log(f"[2] build: {wall:.2f} s wall, nvcc {nvcc if nvcc is None else round(nvcc, 2)} s")
    with open(f"{build.BUILD_DIR}/build.log") as f:
        for line in f:
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                log("    " + line.strip())
    return wall


def make_problem(device):
    """The bench sweep pair, features and compacted clouds on ``device``."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import features

    world = sim.make_room_world(seed=WORLD_SEED, device=device)
    p0 = torch.eye(4, device=device)
    p0[1, 3] = 1.5
    c, s = np.cos(0.02), np.sin(0.02)
    motion = torch.tensor([[c, 0, s, 0.1], [0, 1, 0, 0], [-s, 0, c, 0.35], [0, 0, 0, 1]],
                          dtype=torch.float32, device=device)
    cfg = RegistrationConfig(n_rings=RINGS, max_points_per_ring=WIDTH)
    f_prev = features.extract_features(sim.scan_sweep(world, p0, p0, RINGS, WIDTH), cfg)
    f_cur = features.extract_features(sim.scan_sweep(world, p0, p0 @ motion, RINGS, WIDTH), cfg)
    return (snug(f_cur.sharp), snug(f_cur.flat), snug(f_prev.less_sharp),
            snug(f_prev.less_flat), motion)


def snug(cl, granule=256):
    """``cl`` compacted to its valid count rounded up to ``granule``."""
    from cooper_mapper_torch.utils import cloud

    return cloud.compact(cl, -(-int(cl.mask.sum()) // granule) * granule)


def tile(cl, b):
    from cooper_mapper_torch.utils.cloud import Cloud

    return Cloud(*(t[None].expand((b,) + tuple(t.shape)).contiguous()
                   for t in (cl.xyz, cl.mask, cl.ring, cl.rel_time)))


def time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_race(label, kernel_out, plain_out):
    """(idx, dist) pairs: equal indices inside the gate except true ties,
    distances within DIST_RTOL.  Returns the max abs distance error."""
    ik, dk = kernel_out
    ip, dp = plain_out
    torch.cuda.synchronize()
    if not (torch.isfinite(dk).all() and torch.isfinite(dp).all()):
        fail(f"{label}: non-finite distance")
    err = (dk - dp).abs()
    bad_d = int((err > DIST_RTOL * dp.abs() + 1e-6).sum())
    gated = dp < GATE
    differ = gated & (ik != ip)
    tie = differ & (err <= TIE_RTOL * dp.abs())
    n_q = ip.numel()
    n_bad_i = int((differ & ~tie).sum())
    n_tie = int(tie.sum())
    log(f"    {label}: {n_q} queries, {int(gated.sum())} gated in, index mismatches "
        f"{n_bad_i}, ties {n_tie}, distance mismatches {bad_d}, max |dd| {float(err.max()):.3g}")
    if n_bad_i or bad_d or n_tie > MAX_TIE_SHARE * n_q:
        fail(f"{label} disagrees with its plain version")
    return float(err.max())


def race_bytes(B, Q, M, n_out, with_ring):
    inputs = B * Q * 12 + M * 16 + (M * 4 + B * Q * 8 if with_ring else 0)
    return inputs + n_out * B * Q * 8


def kernel_phase(sharp, flat, ref_c, ref_s, x0):
    """Each race kernel against its plain version on the main path's inputs:
    the de-warped query clouds of the first correspondence refresh."""
    from cooper_mapper_torch.ops import neighbors, races
    from cooper_mapper_torch.utils import twist

    log("[3] kernels vs plain versions at the main path's shapes")
    qc = twist.warp_to_start(x0, sharp.xyz, sharp.rel_time).contiguous()
    qs = twist.warp_to_start(x0, flat.xyz, flat.rel_time).contiguous()
    B = qc.shape[0]
    span = 2.5
    rows = {}

    def ring_inputs(q, ref):
        ia, _ = races.nn1_plain(q, ref.xyz, ref.mask)
        return neighbors.take_ref(ref.ring, ia, ref.xyz.dim() == 2), ia

    # race A: corner and surf searches, shared reference; surf per problem too
    errs = []
    for tag, q, ref in (("corner", qc, ref_c), ("surf", qs, ref_s)):
        errs.append(compare_race(f"nn1 {tag} {tuple(q.shape)} vs {tuple(ref.xyz.shape)}",
                                 races.nn1(q, ref.xyz, ref.mask),
                                 races.nn1_plain(q, ref.xyz, ref.mask)))
    ref_sb = tile(ref_s, B)
    errs.append(compare_race(f"nn1 surf per-problem ref {tuple(ref_sb.xyz.shape)}",
                             races.nn1(qs, ref_sb.xyz, ref_sb.mask),
                             races.nn1_plain(qs, ref_sb.xyz, ref_sb.mask)))
    rows["nn1"] = dict(err=max(errs), q=qs, ref=ref_s)

    # ring race, "adj" (corner race B, on the main path) and "same"
    ra, ia = ring_inputs(qc, ref_c)
    errs = []
    for mode in ("adj", "same"):
        args = (qc, ra, ia, ref_c.xyz, ref_c.ring, ref_c.mask, mode, span)
        errs.append(compare_race(f"nn1_masked {mode} corner {tuple(qc.shape)}",
                                 races.nn1_masked(*args), races.nn1_masked_plain(*args)))
    rows["nn1_masked"] = dict(err=max(errs), q=qc, ref=ref_c, ra=ra, ia=ia)

    # surf races B and C, shared and per-problem reference
    errs = []
    for tag, ref in (("shared", ref_s), ("per-problem", ref_sb)):
        ra_s, ia_s = ring_inputs(qs, ref)
        args = (qs, ra_s, ia_s, ref.xyz, ref.ring, ref.mask, span)
        k, p = races.bc_races(*args), races.bc_races_plain(*args)
        errs.append(compare_race(f"bc_races B {tag}", k[:2], p[:2]))
        errs.append(compare_race(f"bc_races C {tag}", k[2:], p[2:]))
        if tag == "shared":
            rows["bc_races"] = dict(q=qs, ref=ref_s, ra=ra_s, ia=ia_s)
    rows["bc_races"]["err"] = max(errs)

    # times at the main path's dominant shape of each kernel
    log("    times (CUDA events; wrapper calls; plain = the PyTorch version on the card; "
        "library = torch.cdist chain)")
    big = torch.tensor(races.BIG, device=qs.device)
    out = {}
    for name, r in rows.items():
        q, ref = r["q"], r["ref"]
        Bq, Q, _ = q.shape
        M = ref.xyz.shape[0]
        rexp = ref.xyz[None].expand(Bq, M, 3)
        inval = ~ref.mask
        if name == "nn1":
            kern = lambda: races.nn1(q, ref.xyz, ref.mask)
            plain = lambda: races.nn1_plain(q, ref.xyz, ref.mask)
            lib = lambda: torch.cdist(q, rexp).square_().masked_fill_(inval, big).min(-1)
            n_out, with_ring = 1, False
        else:
            ra_f = r["ra"].float()[..., None]
            ringf = torch.where(ref.mask, ref.ring.float(), torch.tensor(races.RING_INVALID, device=q.device))
            cols = torch.arange(M, device=q.device, dtype=torch.int32)

            def adj_ok():
                rd = (ringf - ra_f).abs_()
                return (rd > 0) & (rd <= span)

            if name == "nn1_masked":
                args = (q, r["ra"], r["ia"], ref.xyz, ref.ring, ref.mask, "adj", span)
                kern = lambda: races.nn1_masked(*args)
                plain = lambda: races.nn1_masked_plain(*args)
                lib = lambda: torch.cdist(q, rexp).square_().masked_fill_(~adj_ok(), big).min(-1)
                n_out, with_ring = 1, True
            else:
                args = (q, r["ra"], r["ia"], ref.xyz, ref.ring, ref.mask, span)
                kern = lambda: races.bc_races(*args)
                plain = lambda: races.bc_races_plain(*args)

                def lib():
                    d = torch.cdist(q, rexp).square_()
                    same = (ringf == ra_f) & (cols != r["ia"][..., None])
                    db = d.masked_fill(~same, big).min(-1)
                    return db, d.masked_fill_(~adj_ok(), big).min(-1)
                n_out, with_ring = 2, True
        ms = time_ms(kern, reps=20)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        library_ms = time_ms(lib, reps=3, warmup=1)
        pairs = Bq * Q * M
        t_ops = pairs * OPS_PER_PAIR[name] / FP32_PEAK_OPS * 1e3
        t_bytes = race_bytes(Bq, Q, M, n_out, with_ring) / HBM_BYTES_PER_S * 1e3
        out[name] = dict(shape=f"{Bq}x{Q} vs {M}", pairs=pairs, err=r["err"], ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"    {name} [{Bq}x{Q} vs {M}, {pairs:.3g} pairs]: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, "
            f"bound {out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})")
    return out


def lane_errors(x, motion):
    from cooper_mapper_torch.utils import se3, twist

    err = se3.se3_log(se3.inverse(motion)[None] @ twist.to_mat(x))
    return err[:, :3].norm(dim=-1), err[:, 3:].norm(dim=-1)


def solve_phase(sharp, flat, ref_c, ref_s, x0, motion):
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry, races
    from cooper_mapper_torch.utils.cloud import Cloud

    cfg = OdometryConfig()
    B = x0.shape[0]
    log(f"[4] main path: batch_odometry_solve, B={B}, default OdometryConfig")
    for k in races.KERNELS:
        k.launches = 0
    x, st = odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0, cfg)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in races.KERNELS}
    n_blocks = -(-cfg.max_iterations // cfg.refresh_every)
    expected = {"nn1": 2 * n_blocks, "nn1_masked": n_blocks, "bc_races": n_blocks}
    log(f"    launches in the main-path run: {launches} (expected {expected})")
    if launches != expected or min(launches.values()) <= 0:
        fail("the main path did not launch every kernel as expected")
    if not torch.isfinite(x).all():
        fail("non-finite lanes")
    log(f"    all {B} lanes finite; converged {int(st.converged.sum())}/{B}; "
        f"iterations used {int(st.iter_used.min())}..{int(st.iter_used.max())}")

    cpu = lambda c, n=None: Cloud(*(t[:n].cpu() if n else t.cpu()
                                    for t in (c.xyz, c.mask, c.ring, c.rel_time)))
    x_cpu, _ = odometry.batch_odometry_solve(
        cpu(sharp, CPU_LANES), cpu(flat, CPU_LANES), cpu(ref_c), cpu(ref_s),
        x0[:CPU_LANES].cpu(), cfg)
    dx = float((x[:CPU_LANES].cpu() - x_cpu).abs().max())
    log(f"    lanes 0..{CPU_LANES - 1} vs the CPU plain-version run: max |dx| {dx:.3g} "
        f"(tolerance {CPU_TOL})")
    if not dx <= CPU_TOL:
        fail("card and CPU solves disagree")

    te, re_ = lane_errors(x, motion)
    log(f"    default path vs ground truth (information): translation max {float(te.max()):.4f} m, "
        f"rotation max {float(re_.max()):.4f} rad")

    rng = np.random.RandomState(1)
    dts = []
    for _ in range(5):
        xr = torch.from_numpy((0.02 * rng.randn(B, 6)).astype(np.float32)).to(x0.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, xr, cfg)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    best, med = min(dts), float(np.median(dts))
    log(f"    steady state: {B / best:.1f} solves/s best, {B / med:.1f} median "
        f"({best * 1e3:.1f} / {med * 1e3:.1f} ms per batch; runs {[round(d * 1e3, 1) for d in dts]})")

    log("[5] ground truth: the same solve with cv_dewarp=False")
    xg, _ = odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0,
                                          dataclasses.replace(cfg, cv_dewarp=False))
    te, re_ = lane_errors(xg, motion)
    log(f"    translation error max {float(te.max()):.4f} m (< {TRANS_TOL}), "
        f"rotation error max {float(re_.max()):.5f} rad (< {ROT_TOL})")
    if not (torch.isfinite(xg).all() and (te < TRANS_TOL).all() and (re_ < ROT_TOL).all()):
        fail("lanes outside the ground-truth bounds")
    return launches, B / best, B / med


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (this script runs on the card only)")
    import cooper_mapper_torch  # noqa: F401  (TF32 off)

    device = "cuda"
    name, smi = card_line()
    build_s = build_phase()

    log("[3] sim -> features -> compacted clouds on the card")
    sharp1, flat1, ref_c, ref_s, motion = make_problem(device)
    log(f"    sharp {tuple(sharp1.xyz.shape)}, flat {tuple(flat1.xyz.shape)}, "
        f"less_sharp {tuple(ref_c.xyz.shape)}, less_flat {tuple(ref_s.xyz.shape)}")
    sharp, flat = tile(sharp1, BATCH), tile(flat1, BATCH)
    x0 = torch.from_numpy((0.02 * np.random.RandomState(0).randn(BATCH, 6))
                          .astype(np.float32)).to(device)
    kern = kernel_phase(sharp, flat, ref_c, ref_s, x0)
    launches, sps_best, sps_med = solve_phase(sharp, flat, ref_c, ref_s, x0, motion)

    sources = {"nn1": ("cooper_mapper_tpu/ops/pallas/nn1.py:69", "nn1_pallas / _nn1_kernel"),
               "nn1_masked": ("cooper_mapper_tpu/ops/pallas/nn1.py:173",
                              "nn1_masked_pallas / _nn1_masked_kernel"),
               "bc_races": ("cooper_mapper_tpu/ops/pallas/nn1.py:301",
                            "bc_races_pallas / _bc_races_kernel")}
    rows = [{
        "name": k, "route": "cuda", "source": "cooper_mapper_torch/csrc/races.cu",
        "replaces": sources[k][0], "launches": launches[k],
        "max_abs_err": v["err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
        "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
        "library_ms": v["library_ms"], "shape": v["shape"],
    } for k, v in kern.items()]
    log(f"[6] summary: build {build_s:.2f} s, {sps_best:.1f} solves/s best "
        f"({sps_med:.1f} median) at B={BATCH} on {name} ({smi})")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
