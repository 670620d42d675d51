"""Port vs JAX package: ``demo_localization`` at a reduced size, driven as
tests/test_torch_demos.py drives the other demos (its 20 map solves are a
file's worth of CPU time)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cooper_mapper_torch.examples import demo_localization as tloc  # noqa: E402
from tests import torch_example_drives as E  # noqa: E402
from tests.test_torch_demos import drive  # noqa: E402


def test_demo_localization_matches_jax(tmp_path):
    # the mapping run, its map saved and reloaded, and the localization run
    # from the offset start: both pipelines' trajectories
    jmod = E.load_example("demo_localization")
    pj, pt, _, (_, errs) = drive(jmod, tloc, lambda: jmod.main(str(tmp_path / "jax")),
                                 lambda: tloc.main(str(tmp_path / "torch"), device="cpu"))
    assert [p.mode for p in pt] == ["mapping", "localization"]
    assert len(errs) == 8 and np.isfinite(errs).all()
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
