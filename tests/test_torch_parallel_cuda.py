"""The parallel layer's collectives and sharded paths on the card (``cuda``).

These tests need an NVIDIA card and skip without one.  The file imports no
JAX; on the card run it with

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -q

Each test forms a one-rank group in its own spawned process (a process
holds one default group): NCCL, and gloo over CUDA tensors, which the
mesh stages through the host.  Over one rank every collective gives its
input back, and the sharded LM equals ``optimize`` bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

# by the name pytest's path insertion gives it: the card's machine has a
# ``tests`` package of its own on the path
import torch_parallel_workers as W  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL and CUDA tensors")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_one_rank_collectives_and_lm_on_card(cuda, tmp_path, backend):
    (res,) = W.run(W.card_rank, 1, tmp_path, device="cuda", backend=backend)
    assert res["device"].startswith("cuda")
    assert res["sum_same"] and res["gather_same"] and res["lm_same"]
