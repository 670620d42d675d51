"""A cell's files cut to a size that a CPU test run holds (not a test file)."""

from __future__ import annotations

import copy

from portbench.harness import spec

CPU_CAPACITIES = {"max_sharp": 32, "max_less_sharp": 128, "max_flat": 64, "max_less_flat": 512}
CPU_MAP = {"max_frame_corner": 128, "max_frame_surf": 256, "surround_corner_capacity": 512,
           "surround_surf_capacity": 1024}


def small(cell: str, batch: int = 6, pool: int = 4, width: int = 360):
    """(workload, config) of ``cell`` at CPU size: ``width`` columns, small
    feature, frame and map capacities, a pool of ``pool`` problems, B =
    ``batch``; the traffic's spreads and the comparison's limits as the
    cell's files have them."""
    wl = copy.deepcopy(spec.workload(cell))
    cfg = copy.deepcopy(spec.config(wl["config"]))
    cfg["sensor"]["width"] = width
    cfg["registration"].update(CPU_CAPACITIES)
    for k, v in CPU_MAP.items():
        if k in cfg:
            cfg[k] = v
    wl["traffic"].update(pool_size=pool, batch=batch)
    wl["check"].update(sample=2 * batch, chunk=batch)
    return wl, cfg


CELLS = ("vlp16_odometry.fleet_b8192", "vlp16_mapping.fleet_b2048",
         "vlp16_mapping.sparse_map_b2048")
