"""Run one cell of the benchmark of ``cooper_mapper_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Builds (first run only) and loads the port's
kernels, makes the cell's inputs from the seed on the card, warms up,
drives the cell's entry for ``--seconds`` seconds (back to back, unless
the workload names another loop), and with ``--trace 1`` traces a few
more calls; then compares a sample of the window's answers with the
plain reference and prints the numbers compared beside their limits on
standard error and, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; ``checks`` last.
Exits non-zero, printing no result, without a CUDA card or with fewer
than the cell asks for, or when a module of JAX or of the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
# and Python's bytecode: where the interpreter's packages ship no compiled
# bytecode (torch's ~2,100 modules), every run would compile them anew
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "cooper_mapper_tpu", "chip_smoke", "benchmarks")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import spec

    bench = spec.benchmark(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t_imports = time.perf_counter()
    torch.zeros(1, device="cuda")
    t_context = time.perf_counter()
    from cooper_mapper_torch import build

    build.library()
    t_kernels = time.perf_counter()
    if build.build_seconds is not None:
        print(f"built the port's kernels in {build.build_seconds:.2f} s", file=sys.stderr)

    from portbench.harness import cell

    result, checks, run = cell.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T_START, bench=bench)
    print(f"card: {power_limit()}", file=sys.stderr)
    phases = {"imports": t_imports - T_START, "CUDA context": t_context - t_imports,
              "kernels' build or load": t_kernels - t_context, **run.setup_phases}
    print(f"set-up {run.setup_s:.2f} s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()), file=sys.stderr)
    ms = sorted(t * 1e3 for t in run.call_s)
    print(f"window: {run.calls} calls of B = {run.n_batch} in {run.window_s:.3f} s, call ms "
          f"min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}", file=sys.stderr)
    result["device"]["count"] = chips
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark may not load were loaded: {found}", file=sys.stderr)
        return 3
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
