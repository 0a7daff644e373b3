"""The CUDA front-end kernel on a card ≡ its plain version.

Every test here is marked `gpu` and skips without a CUDA card (the kernel has
no CPU mode). The module imports no jax, so it also runs where only the
port's dependencies are installed; tests/conftest.py imports jax, so on such
a machine run it as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Gates: `mfcc_tpu_torch.testing` (those of
tests/test_pallas_kernels.py::test_kernel_matches_jnp_twin for the prefix).
"""

import numpy as np
import pytest
import torch

from mfcc_tpu.testing.golden import golden_signals
from mfcc_tpu_torch.config import NAMED_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.pipeline import pad_batch
from mfcc_tpu_torch.testing import assert_features_close, assert_prefix_close

pytestmark = pytest.mark.gpu

SIGNALS = ("noise", "speechish", "short", "tone_offbin")
BOUNDARY_LENGTHS = [0, 1, 399, 400, 401, 32 * 160 - 1, 32 * 160, 32 * 160 + 1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pcm_batch(cfg):
    sigs = golden_signals()
    return pad_batch([np.round(sigs[n] * 3000) for n in SIGNALS], cfg, dtype="int16")


@pytest.mark.parametrize("config_name", ["classic13", "classic13_deltas"])
def test_kernel_matches_reference(config_name):
    dev = _card()
    cfg = NAMED_CONFIGS[config_name]
    b = _pcm_batch(cfg)
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    before = frontend.launches
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert frontend.launches == before + 1
    assert_prefix_close(got, frontend.logmel_prefix_reference(audio, lengths, cfg), cfg.n_mels)


def test_int16_dirty_tails_and_boundary_lengths():
    dev = _card()
    cfg = NAMED_CONFIGS["classic13"]
    g = np.random.default_rng(11)
    pcm = (g.standard_normal((len(BOUNDARY_LENGTHS), 6000)) * 3000).astype(np.int16)
    lengths = torch.tensor(BOUNDARY_LENGTHS, dtype=torch.int32, device=dev)
    dirty = torch.as_tensor(pcm, device=dev)
    clean = dirty.clone()
    for i, n in enumerate(BOUNDARY_LENGTHS):
        clean[i, n:] = 0
    got = frontend.logmel_prefix(dirty, lengths, cfg)
    assert torch.equal(got, frontend.logmel_prefix(clean, lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(dirty.float(), lengths, cfg))
    assert_prefix_close(got, frontend.logmel_prefix_reference(clean, lengths, cfg), cfg.n_mels)


def test_kernel_refuses_what_it_does_not_take():
    dev = _card()
    cfg = NAMED_CONFIGS["classic13"]
    audio = torch.zeros((2, 4000), dtype=torch.int16, device=dev)
    lengths = torch.tensor([4000, 10], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        frontend.logmel_prefix(audio[:, ::2], lengths, cfg)
    with pytest.raises(ValueError, match="int32"):
        frontend.logmel_prefix(audio, lengths.long(), cfg)
    with pytest.raises(ValueError, match="int16 or float32"):
        frontend.logmel_prefix(audio.double(), lengths, cfg)
    with pytest.raises(NotImplementedError, match="conditioning"):
        frontend.logmel_prefix(audio, lengths, NAMED_CONFIGS["kaldi_fbank"])


def test_extract_batch_on_card_matches_cpu():
    _card()
    cfg = NAMED_CONFIGS["classic13_deltas"]
    b = _pcm_batch(cfg)
    before = frontend.launches
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    assert feat.device.type == "cuda" and frontend.launches == before + 1
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert_features_close(feat, cpu)
    assert torch.equal(mask.cpu(), cpu_mask)
    with pytest.raises(NotImplementedError, match="float32"):
        chain.extract_batch(b.audio, b.lengths, cfg.replace(dtype="float64"))
