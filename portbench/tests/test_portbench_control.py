"""The control (the plain reference with its matrix products in TF32, put in
the program's place) comes out not correct under each cell's limits, and
the program does not, at CPU size.  On the chip the same readings, at the
cells' own sizes, come from ``portbench/control.py``."""

import pytest
import torch

from portbench import control
from portbench.harness import compare, spec
from portbench.tests.small import CELLS, small

torch.set_num_threads(1)


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_and_program_passes(cell_name):
    wl, cfg = small(cell_name)
    limits = spec.workload(cell_name)["check"]["limits"]
    for row in control.readings(cell_name, [2**31 + 21], 2, device="cpu", workload=wl,
                                config=cfg):
        assert compare.judge(row["program"], limits)[0], row["program"]
        assert not compare.judge(row["control"], limits)[0], row["control"]
