"""Named-frame pose tree: the tf-republisher equivalents (port of
``cooper_mapper_tpu/utils/frames.py``, numpy only, copied as it is).

The reference's demo bring-up republishes odometry/pose/IMU messages as a
tf chain with stabilized intermediate frames
(driver/src/messege_to_tf.cpp:100-175: map ->
base_stabilized (yaw only) -> base_footprint (yaw, ground-projected) ->
base_link (full pose), with roll/pitch split out when publish_roll_pitch)
and a static planar base_link->laser transform
(driver/src/tf_2D_broadcaster.cpp).  There is no runtime
broadcast here — frames are pose algebra — but the DECOMPOSITION the tree
encodes (which part of the pose each consumer sees) is behavior worth
keeping: planners consume base_footprint, stabilized sensors
base_stabilized.

All matrices are [4, 4] float32 in the LOAM working frame (y up).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def yaw_of(T: np.ndarray) -> float:
    """Heading about the +y (up) axis of the working frame."""
    fwd = T[:3, :3] @ np.array([0.0, 0.0, 1.0])
    return float(np.arctan2(fwd[0], fwd[2]))


def _yaw_mat(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array(
        [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32
    )
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    return out


def frame_tree(T_map_base: np.ndarray,
               T_base_laser: np.ndarray | None = None) -> Dict[str, np.ndarray]:
    """Decompose a full pose into the messege_to_tf frame chain.

    Returns {frame: T_map_frame} for base_link (full pose), base_stabilized
    (position + yaw, roll/pitch removed — messege_to_tf.cpp's
    "stabilized_frame"), base_footprint (yaw + ground-projected position,
    height removed), and laser (base_link composed with the static
    extrinsic, tf_2D_broadcaster's role) when ``T_base_laser`` is given.
    """
    T = np.asarray(T_map_base, np.float32)
    yaw = yaw_of(T)

    stabilized = _yaw_mat(yaw)
    stabilized[:3, 3] = T[:3, 3]

    footprint = _yaw_mat(yaw)
    footprint[:3, 3] = T[:3, 3]
    footprint[1, 3] = 0.0                      # ground-projected (y up)

    out = {
        "base_link": T,
        "base_stabilized": stabilized,
        "base_footprint": footprint,
    }
    if T_base_laser is not None:
        out["laser"] = (T @ np.asarray(T_base_laser, np.float32)).astype(
            np.float32)
    return out


def roll_pitch_of(T: np.ndarray) -> tuple[float, float]:
    """The roll/pitch split messege_to_tf publishes between stabilized and
    base_link (publish_roll_pitch branch): the residual rotation after
    removing yaw, decomposed about the forward (z) and lateral (x) axes."""
    R_res = _yaw_mat(-yaw_of(T))[:3, :3] @ np.asarray(T, np.float32)[:3, :3]
    pitch = float(np.arcsin(np.clip(-R_res[1, 2], -1.0, 1.0)))
    roll = float(np.arctan2(R_res[1, 0], R_res[1, 1]))
    return roll, pitch
