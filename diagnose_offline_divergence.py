"""Where the offline runner's card and CPU trajectories part at HDL-64E
(chip_smoke.py phase 37), measured on the card.

From one build of the kernels it runs:
  1. chip_smoke.py's phases 37 and 38 (run() at HDL-64E and HDL-32 at full
     width, the CPU side with its replay of the card's solves, and their
     gates); a gate that fails is reported and the script goes on;
  2. the HDL-64E drive's first 4 files again on the card, and on copies of
     them with every coordinate moved by one ulp up and by one ulp down;
  3. the same files on the CPU in four concurrent processes: the unmoved
     files at 2 and at 3 threads, the moved ones at 2.
It prints max |dW| per sweep between every two of these runs (and the
phase's own 4-thread CPU run).  A one-ulp move of the input is a difference
of rounding size; the spread it causes on each device is the witness of
how far the drive itself amplifies such a difference, beside the card's
difference from the CPU.

Run on a machine with a CUDA card, from the root of the repo:
  python3 diagnose_offline_divergence.py
"""

import contextlib
import io
import itertools
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as C

SENSOR, CPU_RUNS_TIMEOUT = "hdl64", 900
# name -> (the files' ulp move, CPU threads)
CPU_RUNS = {"cpu2": (0, 2), "cpu3": (0, 3), "cpu2_up": (1, 2), "cpu2_down": (-1, 2)}


def moved_copy(src, dst, direction):
    """The .npz sweeps of ``src`` with every coordinate one ulp up (+1) or
    down (-1), written to ``dst``."""
    os.makedirs(dst)
    for name in sorted(os.listdir(src)):
        xyz = np.load(os.path.join(src, name))["xyz"]
        np.savez(os.path.join(dst, name),
                 xyz=np.nextafter(xyz, np.float32(direction * np.inf)).astype(np.float32))


def cpu_run(sweep_dir, out_dir, threads, result):
    """run() at HDL-64E on the CPU (a subprocess); the trajectory to ``result``."""
    torch.set_num_threads(threads)
    from cooper_mapper_torch.examples import run_offline

    with contextlib.redirect_stdout(io.StringIO()):
        pipe = run_offline.run(sweep_dir, out_dir, SENSOR, "mapping", 2, device="cpu")
    np.save(result, np.stack(pipe.trajectory))


def card_run(sweep_dir, out_dir):
    from cooper_mapper_torch.examples import run_offline

    with contextlib.redirect_stdout(io.StringIO()):
        pipe = run_offline.run(sweep_dir, out_dir, SENSOR, "mapping", 2, device="cuda")
    return np.stack(pipe.trajectory)


def gated(what, fn, *args):
    """``fn(*args)``; a failed gate is printed, not raised."""
    try:
        return fn(*args)
    except SystemExit as e:
        C.log(f"    GATE FAILED ({what}): {e}")
        return None


def main():
    if not torch.cuda.is_available():
        C.fail("no CUDA device (this script runs on the card only)")
    import cooper_mapper_torch  # noqa: F401  (TF32 off)

    os.environ["COOPER_PALLAS_FUSED"] = "0"
    C.card_line()
    C.build_phase()
    with tempfile.TemporaryDirectory() as root:
        offline, children = {}, {}
        try:
            for s in C.OFFLINE_SENSORS:
                offline[s] = C.offline_phase(s, root, {}, "cuda")
            children = {s: C.offline_cpu_start(s, offline[s]) for s in C.OFFLINE_SENSORS}
            for s in C.OFFLINE_SENSORS:
                gated(f"phase {C.OFFLINE_SENSORS[s][0]}", C.offline_cpu_check, s, offline[s],
                      children[s])
        finally:
            C.stop_children(children.values())

        run = offline[SENSOR]
        base = run["sweep_dir"]
        dirs = {0: base}
        for direction, tag in ((1, "up"), (-1, "down")):
            dirs[direction] = os.path.join(root, f"moved_{tag}")
            moved_copy(base, dirs[direction], direction)
        t0 = time.perf_counter()
        procs = {}
        for name, (direction, threads) in CPU_RUNS.items():
            res = os.path.join(root, f"{name}.npy")
            code = (f"import sys; sys.path.insert(0, {C.ROOT!r}); "
                    f"import diagnose_offline_divergence as D; "
                    f"D.cpu_run({dirs[direction]!r}, {os.path.join(root, 'out_' + name)!r}, "
                    f"{threads}, {res!r})")
            procs[name] = (subprocess.Popen([sys.executable, "-c", code], cwd=C.ROOT), res)
        runs = {"card_phase": run["trajectory"][:C.OFFLINE_CPU_SWEEPS],
                "cpu4_phase": np.load(os.path.join(run["dir"], "cpu.npy"))}
        # the card's runs while the CPU's go on
        for name, direction in (("card", 0), ("card_up", 1), ("card_down", -1)):
            runs[name] = card_run(dirs[direction], os.path.join(root, "out_" + name))
        try:
            for name, (proc, res) in procs.items():
                rc = proc.wait(timeout=max(1.0, CPU_RUNS_TIMEOUT - (time.perf_counter() - t0)))
                if rc != 0:
                    C.fail(f"the CPU run {name} failed (rc {rc})")
                runs[name] = np.load(res)
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        C.log(f"[diag] HDL-64E, the first {C.OFFLINE_CPU_SWEEPS} files: card runs on the files "
              f"and on one-ulp moves of them; CPU runs {CPU_RUNS} (name: (ulp move, threads)) "
              f"in {time.perf_counter() - t0:.1f} s; cpu4_phase is phase 37's CPU run "
              f"({C.OFFLINE_CPU_THREADS} threads), card_phase the phase's card run")
        for a, b in itertools.combinations(runs, 2):
            dx = np.abs(runs[a] - runs[b]).max(axis=(1, 2))
            C.log(f"    max |dW| per sweep {a} vs {b}: {dx.round(6).tolist()}")
    C.log("[diag] done")


if __name__ == "__main__":
    main()
