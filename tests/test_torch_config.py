"""The port's copies of the configuration dataclasses match the JAX package's
field for field (name, type annotation and default), so they cannot drift.
The port's ``PipelineConfig`` holds a subset of the JAX package's fields,
each with the same default."""

import dataclasses

import pytest

pytest.importorskip("torch")

from cooper_mapper_tpu import config as jax_config  # noqa: E402
from cooper_mapper_torch import config as torch_config  # noqa: E402


@pytest.mark.parametrize("name", ["RegistrationConfig", "OdometryConfig",
                                  "ScanMatchConfig", "MatcherConfig", "MapConfig"])
def test_config_fields_match(name):
    ref = dataclasses.fields(getattr(jax_config, name))
    port = dataclasses.fields(getattr(torch_config, name))
    assert [(f.name, str(f.type), f.default) for f in port] == \
        [(f.name, str(f.type), f.default) for f in ref]
    assert getattr(torch_config, name).__dataclass_params__.frozen


def test_pipeline_config_subset_matches():
    ref = {f.name: f for f in dataclasses.fields(jax_config.PipelineConfig)}
    port = dataclasses.fields(torch_config.PipelineConfig)
    assert [f.name for f in port] == ["registration", "odometry", "scan_match", "feature_map",
                                      "matcher", "mapping_stride"]
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
