"""cooper_mapper_torch — the PyTorch/CUDA port of cooper_mapper_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``cooper_mapper_tpu``), ported
slice by slice.  This package imports ``torch`` and numpy only: never
``jax`` and nothing of ``cooper_mapper_tpu`` (the machine that holds the
card has no JAX).  Plain tensor code is PyTorch; every TPU kernel on a
ported path is a hand-written CUDA kernel for ``sm_90a`` under ``csrc/``,
built on first use by ``build.py``.

Entry points that create tensors take ``device`` and default to ``"cuda"``;
the CPU runs the kernels' plain PyTorch versions (``device="cpu"``).
"""

import torch

# Geometry needs true f32 products: TF32 keeps ~3 decimal digits, larger than
# the solvers' convergence thresholds (0.1 deg / 1 mm).  The JAX package forces
# "highest" matmul precision for the same reason.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
