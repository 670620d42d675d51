"""Discrete Bayes-filter localization tutorials (1D and 2D); the port's own
copy of ``examples/bayes_filter_tutorial.py`` (numpy only).

Modern re-design of the reference's educational scripts
(localization_toturial/intuition_in_1D.py and 2D_Space.py, Python 2): a
robot on a grid senses door/landmark cells and moves with noise; the
posterior sharpens with each sense/move cycle.  Vectorized with numpy
(convolutions for motion, elementwise products for sensing).

Run:  python -m cooper_mapper_torch.examples.bayes_filter_tutorial
"""

import numpy as np


def sense_1d(p, world, measurement, p_hit=0.6, p_miss=0.2):
    q = np.where(np.asarray(world) == measurement, p_hit, p_miss) * p
    return q / q.sum()


def move_1d(p, step, p_exact=0.8, p_under=0.1, p_over=0.1):
    n = len(p)
    idx = np.arange(n)
    return (
        p_exact * p[(idx - step) % n]
        + p_under * p[(idx - step + 1) % n]
        + p_over * p[(idx - step - 1) % n]
    )


def demo_1d():
    world = ["green", "red", "red", "green", "green"]
    p = np.full(5, 0.2)
    for meas, step in [("red", 1), ("green", 1)]:
        p = sense_1d(p, world, meas)
        p = move_1d(p, step)
    print("1D posterior:", np.round(p, 4))
    print("  most likely cell:", int(np.argmax(p)))
    return p


def sense_2d(p, world, measurement, sensor_right=0.7):
    hit = np.asarray(world) == measurement
    q = np.where(hit, sensor_right, 1.0 - sensor_right) * p
    return q / q.sum()


def move_2d(p, dy, dx, p_move=0.8):
    moved = np.roll(np.roll(p, dy, axis=0), dx, axis=1)
    return p_move * moved + (1.0 - p_move) * p


def demo_2d():
    world = np.array(
        [
            ["R", "G", "G", "R", "R"],
            ["R", "R", "G", "R", "R"],
            ["R", "R", "G", "G", "R"],
            ["R", "R", "R", "R", "R"],
        ]
    )
    measurements = ["G", "G", "G", "G", "G"]
    motions = [(0, 0), (0, 1), (1, 0), (1, 0), (0, 1)]
    p = np.full(world.shape, 1.0 / world.size)
    for meas, (dy, dx) in zip(measurements, motions):
        p = move_2d(p, dy, dx)
        p = sense_2d(p, world, meas)
    print("2D posterior:")
    print(np.round(p, 4))
    iy, ix = np.unravel_index(np.argmax(p), p.shape)
    print(f"  most likely cell: ({iy}, {ix})")
    return p


if __name__ == "__main__":
    demo_1d()
    demo_2d()
