"""Port vs JAX package: the offline runner at the HDL-32 and HDL-64E
presets' rings, ring mappers and feature capacities (64 x 256 for the
HDL-64E), on the same sweep files; tests/test_torch_examples.py has the
VLP-16 run and says how both scripts are driven."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests import test_torch_examples as X  # noqa: E402


@pytest.mark.parametrize("sensor", ["hdl32", "hdl64"])
def test_run_matches_jax(tmp_path, monkeypatch, sensor):
    X.check_run(tmp_path, monkeypatch, sensor)
