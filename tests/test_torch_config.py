"""The port's copies of the configuration dataclasses match the JAX package's
field for field (name, type annotation and default), so they cannot drift.
The port's ``PipelineConfig`` holds every field of the JAX package's, each
with the same default, and the per-sensor presets equal the JAX package's."""

import dataclasses

import pytest

pytest.importorskip("torch")

from cooper_mapper_tpu import config as jax_config  # noqa: E402
from cooper_mapper_torch import config as torch_config  # noqa: E402


@pytest.mark.parametrize("name", ["RegistrationConfig", "OdometryConfig",
                                  "ScanMatchConfig", "MatcherConfig", "MapConfig",
                                  "UKFConfig", "KeyframeConfig", "LoopConfig",
                                  "PoseGraphConfig"])
def test_config_fields_match(name):
    ref = dataclasses.fields(getattr(jax_config, name))
    port = dataclasses.fields(getattr(torch_config, name))
    assert [(f.name, str(f.type), f.default) for f in port] == \
        [(f.name, str(f.type), f.default) for f in ref]
    assert getattr(torch_config, name).__dataclass_params__.frozen


def test_pipeline_config_subset_matches():
    ref = {f.name: f for f in dataclasses.fields(jax_config.PipelineConfig)}
    port = dataclasses.fields(torch_config.PipelineConfig)
    assert [f.name for f in port] == list(ref)
    for f in port:
        want = ref[f.name].default
        got = f.default
        if dataclasses.is_dataclass(want):
            # the nested config equals the JAX default field for field
            assert type(got).__name__ == type(want).__name__
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want
    assert torch_config.PipelineConfig.__dataclass_params__.frozen
    hash(torch_config.PipelineConfig())


@pytest.mark.parametrize("preset", ["vlp16", "hdl32", "hdl64", "pandar40", "tiny_test"])
def test_presets_match(preset):
    got, want = getattr(torch_config, preset)(), getattr(jax_config, preset)()
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
