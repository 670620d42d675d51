"""The loop-closure drive at full width (16 x 1024): the port's scenario
helpers against the JAX package's, and both packages' map solves on the
same noisy sweeps.

``sim.loop_drive`` draws its 0.03 m of noise from a ``torch.Generator``, so
its sweeps cannot equal the JAX simulator's; the JAX pipeline is fed the
port's sweeps (simulated on the CPU), with op-by-op extraction
(tests/torch_pipeline_drives.py says why).  The configuration is the
default ``PipelineConfig`` but for a 7 x 7 x 7 cube grid and trimmed
surround and frame capacities, which keep the CPU run small; the test
checks that nothing it holds reaches them (so no point is dropped and the
scores are those of the default sizes).  Tolerances: each solve's score
within 1e-3 relative (tests/torch_pipeline_drives.py::check_stats) plus 1,
the term of one feature (the two packages' distances round differently, so
a feature on a gate's edge may count in one and not the other: measured
0.995 in one solve of the noiseless drive); its match fraction within
1e-3, its gate and feature counts equal.

What it shows: with the noise, the matcher's voxel-filtered frames hold
fewer than 800 features in both packages, and the score adds at most 1 per
feature, so no map solve can reach the default ``score_threshold`` of 800;
without the noise the same drive does reach it.  The loop drive therefore
runs at tests/test_graph_pipeline.py::_cfg's 50 (chip_smoke.py phase 20).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu import config as jc  # noqa: E402
from cooper_mapper_tpu.models import laser_mapping as jlm  # noqa: E402
from cooper_mapper_tpu.models import pipeline as jpipe  # noqa: E402
from cooper_mapper_tpu.ops.features import Sweep as JSweep  # noqa: E402
from cooper_mapper_torch import config as tc  # noqa: E402
from cooper_mapper_torch.io import sim  # noqa: E402
from cooper_mapper_torch.models import laser_mapping as tlm  # noqa: E402
from cooper_mapper_torch.models import pipeline as tpipe  # noqa: E402
from tests import torch_pipeline_drives as D  # noqa: E402

N_SWEEPS = 7            # map solves at sweeps 1 (empty map), 2, 4 and 6
DEFAULT_SCORE = tc.ScanMatchConfig().score_threshold     # 800


def test_loop_drive_is_the_jax_scenario():
    from tests.test_graph_pipeline import _simulate_loop

    _, want = _simulate_loop(n_sweeps=3, width=32)
    sweeps, poses = sim.loop_drive(3, width=32, device="cpu")
    np.testing.assert_array_equal(poses, want)
    assert len(sweeps) == 3 and sweeps[0].xyz.shape == (16, 32, 3)


def trimmed_cfg(m):
    """The default PipelineConfig with a 7 x 7 x 7 grid of 50 m cubes (the
    40 m room fits in it with the 3-cube margin) and capacities trimmed to
    what the drive holds."""
    cfg = m.PipelineConfig()
    return dataclasses.replace(
        cfg,
        feature_map=dataclasses.replace(cfg.feature_map, n_cubes=(7, 7, 7),
                                        surround_corner_capacity=4096,
                                        surround_surf_capacity=8192),
        matcher=dataclasses.replace(cfg.matcher, max_frame_corner=1024, max_frame_surf=2048))


def map_solves(port, sweeps):
    """Each map solve of the package's mapping pipeline over the sweeps:
    (score, match fraction, success, frame corner, frame surf), the counts
    being valid points; and, for the port, each solve's surround (corner,
    surf) valid points (the JAX package gathers it inside ``jit``)."""
    lm = tlm if port else jlm
    step, surround = lm.mapping_step, tlm.fm.get_surround
    out, refs = [], []

    def get_surround(*args, **kw):
        rc, rs = surround(*args, **kw)
        refs.append((int(rc.mask.sum()), int(rs.mask.sum())))
        return rc, rs

    def mapping_step(*args, **kw):
        res = step(*args, **kw)
        mo = res[2]
        out.append((float(mo.result.score), float(mo.result.match_fraction),
                    bool(mo.result.success), int(mo.corner_ds.mask.sum()),
                    int(mo.surf_ds.mask.sum())))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "mapping_step", mapping_step)
        mp.setattr(tlm.fm, "get_surround", get_surround)
        if port:
            pipe = tpipe.SlamPipeline(trimmed_cfg(tc), "mapping", device="cpu")
        else:
            pipe = jpipe.SlamPipeline(trimmed_cfg(jc), "mapping")
            sweeps = [JSweep(*(jnp.asarray(getattr(s, f).numpy())
                               for f in ("xyz", "mask", "rel_time"))) for s in sweeps]
            mp.setattr(jpipe.feat_ops, "extract_features",
                       lambda sweep, cfg: D.jfeat._extract_impl(sweep, cfg)[0])
        for s in sweeps:
            pipe.process(s)
    return np.array(out), np.array(refs)


@pytest.mark.parametrize("noise", [0.03, 0.0])
def test_map_solve_scores_match_jax_on_the_noisy_loop(noise):
    sweeps, _ = sim.loop_drive(N_SWEEPS, noise=noise, device="cpu")
    (got, refs), (want, _) = map_solves(True, sweeps), map_solves(False, sweeps)
    assert got.shape == want.shape == (4, 5)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3, atol=1.0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-3)
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])
    cfg = trimmed_cfg(tc)
    caps = (cfg.matcher.max_frame_corner, cfg.matcher.max_frame_surf,
            cfg.feature_map.surround_corner_capacity, cfg.feature_map.surround_surf_capacity)
    held = np.concatenate([got[:, 3:], refs], axis=1)
    assert (held < np.array(caps)).all(), "a trimmed capacity was reached"
    scores, features = got[1:, 0], got[1:, 3] + got[1:, 4]
    assert (scores <= features).all()      # one term of at most 1 per feature
    if noise:
        assert (features < DEFAULT_SCORE).all() and not got[:, 2].any()
    else:
        assert (scores >= DEFAULT_SCORE).any() and got[:, 2].any()
