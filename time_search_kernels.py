"""Device times of the search kernels (k-NN, bc_races, nn1, nn1_masked,
fused_races, merge_min) at the main paths' shapes, for one checkout of the
port at a time, on one NVIDIA card.

    python3 time_search_kernels.py --save-inputs FILE
    python3 time_search_kernels.py --inputs FILE [--root DIR] [--label NAME] [--only KINDS]
                                   [--variants]

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
  (phase 8);
* nn1 512x768 vs 3840 and 512x256 vs 256, nn1_masked "adj" 512x256 vs 256:
  the odometry batch solve's surf and corner searches at its first
  correspondence refresh (phase 3);
* nn1 1x1024 vs 8192 and 1x256 vs 2048, nn1_masked "adj" 1x256 vs 2048: the
  single-stream drive's first surf and corner searches (phase 8);
* fused_races at the same four shapes, surf (with race B) against the
  less-flat reference and corner against the less-sharp one: the fused
  route's searches (``COOPER_PALLAS_FUSED=1``);
* merge_min on the chunks' results of nn1 at 1x1024 vs 8192 split as its
  plan splits it (S = 66), and into S = 32 and S = 2; of nn1 at 1x256 vs
  2048 (S = 32); and of bc_races' two searches at 1x1024 vs 8192 (S = 66).

Two kinds are timed on the k-NN inputs above, with nothing more saved:

* ``knn_select``: the select route (``knn.knn_select``) at 64x2048 vs 5888
  and 1x8192 vs 65536 at k = 33, 64 and 257;
* ``merge_first_k``: the split k-NN's merge inside ``knn.knn`` at the two
  B = 1 sweep searches as their plan splits them (1x2048 vs 32768, S = 66;
  1x8192 vs 65536, S = 17) at k = 5 and 10, its device ms read by kernel
  name, so that a checkout with no entry of its own for the merge is timed
  the same way.

The second form imports ``cooper_mapper_torch`` from ``--root`` (default:
this checkout), so that two commits can be timed on the same inputs, in
turns, on one card (parent, change, change, parent).  For each search it
checks the kernel against its plain version, bit for bit, then prints one
JSON line with, per search: the wrapper's ms per call (CUDA events over 20
calls after 2 warm-ups, as ``chip_smoke.py`` times them); the device ms per
call of the port's own kernels in it (``torch.profiler`` over 20 calls, as
``profile_torch_solve.py`` reports them), with their launches per call, and
of every kernel the call launches (the wrapper's input prep included); the
bound (``chip_smoke.py``'s valid pairs, each query against the valid
reference points, x FP32 operations per pair over the non-FMA FP32 rate,
or for merge_min the bytes over the HBM rate); the card's name and power
limit.  ``device_ms_by_kernel`` splits the port's kernels by name,
so that merge_min's time inside a split race is read in a checkout that has
no merge_min kind.  ``--variants`` also times each fused plan
(``races.FUSED_PLANS``, forced through ``plan=``) and each block shape of
the warp select (1, 2, 4 or 8 queries per block), where the checkout has
them.  Another design variant (a fused plan added to ``FUSED_PLANS`` and to
``launch_fused_plan`` in ``csrc/races.cu``, merge_min's ``MERGE_QB`` /
``MERGE_WARPS`` in ``csrc/split.cuh``) is timed as a checkout: edit it in a
copy and pass ``--root``.
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
# the k-NN inputs (and k) of the derived kinds
SELECT_INPUTS, SELECT_KS = ("knn 64x2048 vs 5888", "knn 1x8192 vs 65536 (surf)"), (33, 64, 257)
MERGE_INPUTS, MERGE_KS = ("knn 1x2048 vs 32768 (corner)", "knn 1x8192 vs 65536 (surf)"), (5, 10)


def save_inputs(path):
    from cooper_mapper_torch.build import library
    from cooper_mapper_torch.ops import races
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
    sq, fq, c_ref, s_ref = clouds
    ra, ia = cs.race_a_ring(fq, s_ref)
    out["bc_races 1x1024 vs 8192"] = dict(kind="bc_races", q=fq, ra=ra, ia=ia, **ref(s_ref))
    out["nn1 1x1024 vs 8192"] = dict(kind="nn1", q=fq, **ref(s_ref))
    out["nn1 1x256 vs 2048"] = dict(kind="nn1", q=sq, **ref(c_ref))
    ra, ia = cs.race_a_ring(sq, c_ref)
    out["nn1_masked adj 1x256 vs 2048"] = dict(kind="nn1_masked", q=sq, ra=ra, ia=ia, **ref(c_ref))
    out["fused_races surf 1x1024 vs 8192"] = dict(kind="fused_races", q=fq, with_same=True,
                                                  **ref(s_ref))
    out["fused_races corner 1x256 vs 2048"] = dict(kind="fused_races", q=sq, with_same=False,
                                                   **ref(c_ref))
    n_sm = races.sm_count(dev)
    nn1_bq = library().cooper_nn1_block_queries()
    for q, r, S in ((fq, s_ref, None), (fq, s_ref, 32), (fq, s_ref, 2), (sq, c_ref, None)):
        S = S or races._split_plan(1, q.shape[1], r.xyz.shape[0], n_sm, nn1_bq)[0]
        pd, pi = cs.chunk_partials(q, r, S, "nn1")
        out[f"merge_min S={S} n={q.shape[1]}"] = dict(kind="merge_min", pd=pd, pi=pi)
    S = races._split_plan(1, fq.shape[1], s_ref.xyz.shape[0], n_sm,
                          library().cooper_bc_races_block_queries())[0]
    ra, ia = cs.race_a_ring(fq, s_ref)
    pd, pi = cs.chunk_partials(fq, s_ref, S, "bc_races", ra, ia)
    out[f"merge_min S={S} n={fq.shape[1]} x2 (bc_races)"] = dict(kind="merge_min", pd=pd, pi=pi)

    # odometry batch (phase 3): the de-warped queries of the first refresh
    sharp1, flat1, ref_c, ref_s, _ = cs.make_problem(dev)
    xb = torch.from_numpy((0.02 * np.random.RandomState(0).randn(cs.BATCH, 6))
                          .astype(np.float32)).to(dev)
    warp = lambda c: twist.warp_to_start(xb, c.xyz, c.rel_time).contiguous()
    qs, qc = warp(cs.tile(flat1, cs.BATCH)), warp(cs.tile(sharp1, cs.BATCH))
    ra, ia = cs.race_a_ring(qs, ref_s)
    out["bc_races 512x768 vs 3840"] = dict(kind="bc_races", q=qs, ra=ra, ia=ia, **ref(ref_s))
    out["nn1 512x768 vs 3840"] = dict(kind="nn1", q=qs, **ref(ref_s))
    out["nn1 512x256 vs 256"] = dict(kind="nn1", q=qc, **ref(ref_c))
    ra, ia = cs.race_a_ring(qc, ref_c)
    out["nn1_masked adj 512x256 vs 256"] = dict(kind="nn1_masked", q=qc, ra=ra, ia=ia,
                                                **ref(ref_c))
    out["fused_races surf 512x768 vs 3840"] = dict(kind="fused_races", q=qs, with_same=True,
                                                   **ref(ref_s))
    out["fused_races corner 512x256 vs 256"] = dict(kind="fused_races", q=qc, with_same=False,
                                                    **ref(ref_c))
    torch.save({k: {n: (t.cpu() if torch.is_tensor(t) else t) for n, t in v.items()}
                for k, v in out.items()}, path)
    print(json.dumps({k: tuple(v["pd" if v["kind"] == "merge_min" else "q"].shape)
                      for k, v in out.items()}))


def time_tree(path, label, only=None, variants=False):
    from cooper_mapper_torch.ops import knn, races

    saved = torch.load(path)
    data = {k: v for k, v in saved.items() if not only or v["kind"] in only}
    for kind, inputs, ks in (("knn_select", SELECT_INPUTS, SELECT_KS),
                             ("merge_first_k", MERGE_INPUTS, MERGE_KS)):
        if not only or kind in only:
            data.update({f"{kind} k={k} {name[4:]}": dict(saved[name], kind=kind, k=k)
                         for name in inputs for k in ks})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"label": label, "module": os.path.dirname(knn.__file__), "card": smi}
    for name, v in data.items():
        if v["kind"] == "merge_min" and not hasattr(races, "merge_min"):
            res[name] = "no merge_min entry in this checkout: see the split races' by-kernel times"
            continue
        t = {n: (x.cuda() if torch.is_tensor(x) else x) for n, x in v.items()}
        forced = {}
        if v["kind"] == "merge_min":
            pd, pi = t["pd"], t["pi"]
            kern = lambda: races.merge_min(pd, pi)
            plain = races.merge_min_plain(pd, pi)
            searches, S, n = pd.shape
            bound = (searches * S * n * 8 + searches * n * 8) / cs.HBM_BYTES_PER_S * 1e3
            res[name] = {"searches": searches, "S": S, "n": n}
        else:
            q, r, m = t["q"], t["xyz"], t["mask"]
            ops = cs.OPS_PER_PAIR["knn" if "k" in v else v["kind"]]
            if v["kind"] == "knn_select":
                kern = lambda k=v["k"]: knn.knn_select(q, r, m, k)
                plain = knn.knn_plain(q, r, m, v["k"])
                if variants and hasattr(races, "SELECT_MAX_QB"):
                    forced = {f"plan QB={qb}":
                              (lambda qb=qb, k=v["k"]: knn._knn_select_cuda(q, r, m, k, plan=qb))
                              for qb in (1, 2, 4, 8)}
            elif v["kind"] == "merge_first_k":
                kern = lambda k=v["k"]: knn.knn(q, r, m, k)
                plain = knn.knn_plain(q, r, m, v["k"])
            elif v["kind"] == "knn":
                kern = lambda: knn.knn(q, r, m, 5)
                plain = knn.knn_plain(q, r, m, 5)
            elif v["kind"] == "nn1":
                kern = lambda: races.nn1(q, r, m)
                plain = races.nn1_plain(q, r, m)
            elif v["kind"] == "nn1_masked":
                args = (q, t["ra"], t["ia"], r, t["ring"], m, "adj", 2.5)
                kern = lambda: races.nn1_masked(*args)
                plain = races.nn1_masked_plain(*args)
            elif v["kind"] == "fused_races":
                args = (q, r, t["ring"], m, v["with_same"], 2.5)
                kern = lambda: races.fused_races(*args)
                plain = races.fused_races_plain(*args)
                ops = cs.OPS_PER_PAIR["fused_races" if v["with_same"] else "fused_races_corner"]
                if variants and hasattr(races, "FUSED_PLANS"):
                    forced = {f"plan G={g} QPT={u}":
                              (lambda p=(g, u): races._fused_races_cuda(*args, plan=p))
                              for g, u in races.FUSED_PLANS}
            else:
                args = (q, t["ra"], t["ia"], r, t["ring"], m, 2.5)
                kern = lambda: races.bc_races(*args)
                plain = races.bc_races_plain(*args)
            B, Q, _ = q.shape
            bound = Q * cs.ref_counts(B, m)[2] * ops / cs.FP32_PEAK_OPS * 1e3
            res[name] = {"k": v["k"]} if "k" in v else {}
            if v["kind"] == "merge_first_k":
                from cooper_mapper_torch.build import library

                S = races._split_plan(B, Q, r.shape[0], races.sm_count(q.device),
                                      library().cooper_knn_block_queries(v["k"]))[0]
                bound = (S * B * Q * v["k"] * 8 + B * Q * v["k"] * 8) / cs.HBM_BYTES_PER_S * 1e3
                res[name]["S"] = S
            if v["kind"] == "fused_races" and hasattr(races, "_fused_plan"):
                res[name]["plan"] = races._fused_plan(B, Q, races.sm_count(q.device))
        for tag, fn in {"": kern, **forced}.items():
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise SystemExit(f"time_search_kernels FAILED: {name} {tag} differs from its "
                                 "plain version")
            dms, launches, all_ms, by_kernel = cs.device_ms(fn, cs.OWN_KERNELS, REPS)
            row = {"wrapper_ms": cs.time_ms(fn, REPS), "device_ms": dms,
                   "kernel_launches_per_call": launches, "device_ms_all_kernels": all_ms,
                   "device_ms_by_kernel": by_kernel}
            if tag:
                res[name].setdefault("variants", {})[tag] = row
            else:
                res[name].update(row, bound_ms=bound)
            print(f"{label} {name} {tag}: {row}", flush=True)
    print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save-inputs")
    ap.add_argument("--inputs")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", help="comma-separated kinds to time (knn, knn_select, "
                                   "merge_first_k, bc_races, nn1, nn1_masked, fused_races, "
                                   "merge_min); default all")
    ap.add_argument("--variants", action="store_true",
                    help="also time each fused plan the checkout builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_search_kernels: no CUDA device")
    if args.save_inputs:
        import cooper_mapper_torch  # noqa: F401  (TF32 off)
        save_inputs(args.save_inputs)
        return
    sys.path.insert(0, os.path.abspath(args.root))
    import cooper_mapper_torch  # noqa: F401

    time_tree(args.inputs, args.label, args.only and args.only.split(","), args.variants)


if __name__ == "__main__":
    main()
