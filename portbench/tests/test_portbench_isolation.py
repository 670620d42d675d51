"""Nothing the benchmark loads imports JAX, the JAX package, chip_smoke or
benchmarks/ (top-level module names compared whole, so cooper_mapper_torch
does not match cooper_mapper_tpu), and the reference and the input maker
load nothing of the port."""

import glob
import os
import subprocess
import sys

from portbench.harness import spec

ROOT = spec.ROOT
BLOCK = '''
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "cooper_mapper_tpu", "chip_smoke", "benchmarks"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
'''


def _loaded(code: str) -> set:
    report = "\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    done = subprocess.run([sys.executable, "-c", BLOCK + code + report],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    return set(eval(done.stdout.strip().splitlines()[-1]))


def test_harness_entries_metrics_and_reference_load_no_jax():
    metrics = sorted(os.path.basename(p)[:-3]
                     for p in glob.glob(os.path.join(ROOT, "portbench", "metrics", "*.py")))
    entries = sorted(os.path.basename(p)[:-3]
                     for p in glob.glob(os.path.join(ROOT, "portbench", "entries", "*.py"))
                     if not p.endswith("__init__.py"))
    loops = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(ROOT, "portbench", "loops", "*.py"))
                   if not p.endswith("__init__.py"))
    code = ("import portbench.run, portbench.control\n"
            "from portbench.harness import cell, spec, trace, readers\n"
            "import portbench.reference.solve, portbench.reference.search\n"
            f"for e in {entries!r}: spec.entry(e)\n"
            f"for m in {metrics!r}: spec.metric_reader(m)\n"
            f"for lp in {loops!r}: spec.loop(lp)\n"
            "import cooper_mapper_torch.ops.odometry, cooper_mapper_torch.ops.scan_match\n")
    loaded = _loaded(code)
    assert "cooper_mapper_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cooper_mapper_tpu", "chip_smoke", "benchmarks"}


def test_reference_and_inputs_load_nothing_of_the_port():
    loaded = _loaded("import portbench.reference.solve, portbench.reference.search\n"
                     "import portbench.inputs.pool, portbench.harness.roofline\n")
    assert "cooper_mapper_torch" not in loaded and "portbench" in loaded


def test_run_names_forbidden_modules_by_whole_top_level_name():
    sys.path.insert(0, ROOT)
    import portbench.run as run

    sys.modules.setdefault("cooper_mapper_tpux", sys)   # a longer name is not the package
    try:
        assert "cooper_mapper_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["cooper_mapper_tpux"]
