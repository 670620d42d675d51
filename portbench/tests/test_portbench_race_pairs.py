"""The reader of ``race_pair_share.odometry``
(``portbench/metrics/race_pair_share.py``): on a synthetic span pass, with
nothing to read, and on the pass at CPU size."""

import io
import types

import pytest
import torch

from cooper_mapper_torch.utils import profiling
from portbench.harness import spans, spec
from portbench.tests.small import CELLS, small

torch.set_num_threads(1)
NAME = "race_pair_share.odometry"


def _run(counts):
    calls = [{"root": "odometry.solve", "spans": {}, "counts": c} for c in counts]
    return types.SimpleNamespace(span_pass={"calls": calls})


def test_share_of_the_walked_pairs_over_the_calls():
    read = spec.metric_reader(NAME)
    refresh = lambda w, p: {"odometry.refresh": {"race_pairs_walked": w, "race_pairs_padded": p}}
    assert read(_run([refresh(30, 100), refresh(10, 100)])) == pytest.approx(20.0)
    # a program without the counters: nothing to read
    assert read(_run([{"odometry.refresh": {"race_matched": 5}}])) is None
    assert read(types.SimpleNamespace(span_pass=None)) is None


def test_reader_gives_none_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert spec.metric_reader(NAME)(types.SimpleNamespace(cell=CELLS[0])) is None


def test_share_in_the_pass_at_cpu_size():
    wl, cfg = small(CELLS[0])
    p = spans.measure(CELLS[0], wl, cfg, "cpu", profiling, calls=1, out=io.StringIO())
    share = spec.metric_reader(NAME)(types.SimpleNamespace(span_pass=p))
    assert 0 < share < 100
