"""The readings that a cell's limits are set from, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--calls 2]

For each seed: the cell's inputs, ``--calls`` calls of the program at the
cell's batch, the cell's sample of their problems, and on it the plain
reference at the configuration's precision (float32, TF32 off) and the
control, the same reference computed with TF32 on, put in the program's
place.  Prints one JSON line per seed: every number of
``harness/compare.py`` for the program against the reference
("program") and for the control against the reference ("control"), the
host ms of each call, and the inputs' valid point counts.  Not run by the
benchmark's own runs; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def valid_counts(pool: dict) -> dict:
    """Mean, least and most valid points per cloud of the pool."""
    out = {}
    for name, cloud in pool.items():
        if isinstance(cloud, dict):
            n = cloud["mask"].sum(-1).float()
            out[name] = [round(float(n.mean()), 1), int(n.min()), int(n.max()),
                         cloud["mask"].shape[-1]]
    return out


def readings(name: str, seeds, n_calls: int, device="cuda", workload=None, config=None):
    """Yield one dict of readings per seed (see the module docstring)."""
    import torch

    from portbench.harness import cell, compare, spec
    from portbench.inputs import pool as pool_lib

    wl = workload or spec.workload(name)
    cfg = config or spec.config(wl["config"])
    Entry = spec.entry(wl["entry"])
    check = wl["check"]
    for seed in seeds:
        t0 = time.perf_counter()
        entry = Entry(cfg, wl["traffic"], seed, device)
        cell.sync(device)
        pool_s = time.perf_counter() - t0
        _, gen = pool_lib.generators(seed, cell.CALL_STREAM, device)
        problems, outputs, call_ms = [], [], []
        for _ in range(n_calls):
            p, args = entry.feed(gen)
            cell.sync(device)
            t1 = time.perf_counter()
            out = entry.solve(args)
            cell.sync(device)
            call_ms.append((time.perf_counter() - t1) * 1e3)
            problems.append(p)
            outputs.append(out)
        del args, out
        picked, got = cell.sample(problems, outputs, check["sample"], seed, device)
        t1 = time.perf_counter()
        want = cell.reference(entry, picked, check["chunk"])
        cell.sync(device)
        ref_s = time.perf_counter() - t1
        control = cell.reference(entry, picked, check["chunk"], tf32=True)
        failed = [float(entry.failed(o).double().mean()) for o in outputs]
        yield {"workload": name, "seed": seed, "pool_s": pool_s, "call_ms": call_ms,
               "reference_s": ref_s, "failed_share": failed,
               "program": compare.numbers(got, want),
               "control": compare.numbers(control, want),
               "valid": valid_counts(entry.pool)}
        del entry, problems, outputs, picked, got, want, control
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    for row in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.calls):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
