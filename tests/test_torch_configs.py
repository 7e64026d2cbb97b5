"""The port's architecture configs are copies of the JAX package's."""
import dataclasses

import pytest

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg


def test_same_arch_ids():
    assert treg.ARCH_IDS == jreg.ARCH_IDS


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_config_fields_equal(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jreg, get)(arch)
        got = getattr(treg, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("gpt-5")
