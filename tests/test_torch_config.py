"""The port's copies of the configuration dataclasses match the JAX package's
field for field (name, type annotation and default), so they cannot drift."""

import dataclasses

import pytest

pytest.importorskip("torch")

from cooper_mapper_tpu import config as jax_config  # noqa: E402
from cooper_mapper_torch import config as torch_config  # noqa: E402


@pytest.mark.parametrize("name", ["RegistrationConfig", "OdometryConfig",
                                  "ScanMatchConfig", "MatcherConfig"])
def test_config_fields_match(name):
    ref = dataclasses.fields(getattr(jax_config, name))
    port = dataclasses.fields(getattr(torch_config, name))
    assert [(f.name, str(f.type), f.default) for f in port] == \
        [(f.name, str(f.type), f.default) for f in ref]
    assert getattr(torch_config, name).__dataclass_params__.frozen
