"""Extrinsic calibration loading (a copy of ``cooper_mapper_tpu/fusion/extrinsics.py``,
which is numpy only; the port imports nothing of the JAX package).

Equivalent of ``loadExtrinsic`` (kf_fusion/loadExtrinsic.hpp:8-32): a YAML file with a ``transform: matrix: [16 floats]``
row-major 4x4 lidar->imu transform.
"""

from __future__ import annotations

import numpy as np


def load_extrinsic(path: str) -> np.ndarray:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    mat = np.asarray(data["transform"]["matrix"], np.float32).reshape(4, 4)
    return mat


def save_extrinsic(path: str, T) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(
            {"transform": {"matrix": [float(v) for v in np.asarray(T).reshape(-1)]}}, f
        )


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)
