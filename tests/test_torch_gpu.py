"""The CUDA kernels on a card ≡ their plain versions: the front-end kernel,
its fused resample, and the polyphase resampler.

Every test here is marked `gpu` and skips without a CUDA card (the kernel has
no CPU mode). The module imports no jax, so it also runs where only the
port's dependencies are installed; tests/conftest.py imports jax, so on such
a machine run it as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Gates: `mfcc_tpu_torch.testing` (those of
tests/test_pallas_kernels.py::test_kernel_matches_jnp_twin for the prefix,
1e-5 of the row's max |x| for the resampler, 8e-4 for resampled features).
"""

import numpy as np
import pytest
import torch

from mfcc_tpu.testing.golden import golden_signals
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.kernels import resample as rs_kernel
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.ops import resample
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


# one 16 kHz frame is 1,200 samples at 48 kHz; 16,080 ends the first 32-frame tile
RS_BOUNDARY_LENGTHS = {
    "mfcc39_48k": [0, 1, 2, 3, 1199, 1200, 1201, 16079, 16080, 16081],
    "mfcc39_44k": [0, 1, 2, 3, 1102, 1103, 1104, 14774, 14775, 14776],
}


@pytest.mark.parametrize(
    "sr_in,sr_out", [(48000, 16000), (44100, 16000), (8000, 16000), (22050, 16000)]
)
def test_resample_kernel_matches_reference(sr_in, sr_out):
    dev = _card()
    g = np.random.default_rng(13)
    x = torch.as_tensor((g.standard_normal((3, 48011)) * 3000).astype(np.float32), device=dev)
    before = rs_kernel.launches
    got = resample.resample_batch(x, sr_in, sr_out)
    torch.cuda.synchronize()
    assert rs_kernel.launches == before + 1
    assert got.shape == (3, resample.output_length(48011, sr_in, sr_out))
    err = testing.resample_error(got, rs_kernel.resample_reference(x, sr_in, sr_out), x)
    assert err < testing.RESAMPLE_KERNEL_REL_ROWMAX, err


def test_resample_kernel_refusals():
    dev = _card()
    x = torch.zeros((2, 4800), device=dev)
    with pytest.raises(ValueError, match="float32"):
        resample.resample_batch(x.double(), 48000, 16000)
    with pytest.raises(ValueError, match="232,448 bytes"):
        resample.resample_batch(x, 16000, 15999)
    with pytest.raises(ValueError, match="contiguous"):
        resample.resample_batch(x[:, ::2], 48000, 16000)


@pytest.mark.parametrize("config_name", ["mfcc39_48k", "mfcc39_44k"])
def test_fused_resample_matches_reference(config_name):
    """Boundary input lengths (frame and first-tile edges), garbage past
    each length, int16 ≡ float32 rows."""
    dev = _card()
    cfg = NAMED_CONFIGS[config_name]
    lens = RS_BOUNDARY_LENGTHS[config_name] + [30011]
    g = np.random.default_rng(17)
    pcm = (g.standard_normal((len(lens), 32000)) * 3000).astype(np.int16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    dirty = torch.as_tensor(pcm, device=dev)
    clean = torch.where(torch.arange(32000, device=dev)[None] < lengths[:, None], dirty, 0)
    before = (frontend.launches, frontend.resample_launches, rs_kernel.launches)
    got = frontend.logmel_prefix(dirty, lengths, cfg)
    torch.cuda.synchronize()
    assert (frontend.launches, frontend.resample_launches, rs_kernel.launches) == (
        before[0], before[1] + 1, before[2])
    assert torch.equal(got, frontend.logmel_prefix(clean, lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(dirty.float(), lengths, cfg))
    assert_prefix_close(got, frontend.logmel_prefix_reference(clean, lengths, cfg), cfg.n_mels)


def test_extract_batch_resampled_on_card_matches_cpu():
    """(No pure tone here: at int16 scale its quiet bins are at the fp32
    floor, where any two summation orders differ by ~5e-3.)"""
    _card()
    cfg = NAMED_CONFIGS["mfcc39_48k"]
    sigs = golden_signals(48000)
    names = ("noise", "speechish", "short", "chirp")
    b = pad_batch([np.round(sigs[n] * 3000) for n in names], cfg, dtype="int16")
    before = (frontend.launches, frontend.resample_launches, rs_kernel.launches)
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    assert (frontend.launches, frontend.resample_launches, rs_kernel.launches) == (
        before[0], before[1] + 1, before[2])
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    testing.assert_resampled_features_close(feat, cpu)
    assert torch.equal(mask.cpu(), cpu_mask)
