"""The port's config and host constants ≡ the JAX package's.

The port keeps its own copies of `mfcc_tpu/config.py` and
`mfcc_tpu/ops/constants.py`; these tests hold the copies to the originals:
the same dataclass fields and config hashes for every named config, the
same float64 constants, and `to_torch` carrying either package's numpy
constants onto a device unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mfcc_tpu import config as jconfig
from mfcc_tpu.ops import constants as jconstants
from mfcc_tpu_torch import config as tconfig
from mfcc_tpu_torch.ops import constants as tconstants

NAMES = sorted(jconfig.NAMED_CONFIGS)


def test_named_config_set_is_the_same():
    assert sorted(tconfig.NAMED_CONFIGS) == NAMES
    assert len(NAMES) == 12


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax(name):
    j, t = jconfig.named_config(name), tconfig.named_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.config_hash() == j.config_hash()
    assert (t.frame_length, t.frame_step, t.n_bins, t.feat_dim) == (
        j.frame_length, j.frame_step, j.n_bins, j.feat_dim
    )
    for n in (0, 1, 399, 400, 401, 16000, 160000):
        assert t.num_frames(n) == j.num_frames(n)


@pytest.mark.parametrize("name", NAMES)
def test_chain_constants_match_jax(name):
    j = jconstants.chain_constants(jconfig.named_config(name))
    t = tconstants.chain_constants(tconfig.named_config(name))
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == np.float64
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_config_with_overrides_matches_jax():
    sets = ["window=povey", "n_mels=40", "mel_high_hz=none", "append_energy=false",
            "preemph=0.5"]
    j = jconfig.config_with_overrides(jconfig.named_config("classic13"), sets)
    t = tconfig.config_with_overrides(tconfig.named_config("classic13"), sets)
    assert t.config_hash() == j.config_hash()
    with pytest.raises(ValueError):
        tconfig.config_with_overrides(t, ["no_such_key=1"])
    with pytest.raises(ValueError):
        tconfig.config_with_overrides(t, ["append_energy=maybe"])


def test_config_validation_and_unknown_name():
    with pytest.raises(ValueError):
        tconfig.FrontendConfig(window="triangle")
    with pytest.raises(ValueError):
        tconfig.FrontendConfig(n_ceps=30)
    with pytest.raises(KeyError):
        tconfig.named_config("classic14")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_to_torch_carries_jax_constants(dtype):
    """to_torch is how the JAX package's numpy constants reach the port:
    same keys, one cast from float64, nothing else."""
    host = jconstants.chain_constants(jconfig.named_config("classic13_deltas"))
    dev = tconstants.to_torch(host, "cpu", dtype)
    assert sorted(dev) == sorted(host)
    for k, v in host.items():
        assert dev[k].dtype == dtype and dev[k].device.type == "cpu"
        np.testing.assert_array_equal(dev[k].numpy(), v.astype(dev[k].numpy().dtype))
