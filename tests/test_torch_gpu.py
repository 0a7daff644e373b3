"""The CUDA kernels on a card ≡ their plain versions: the front-end kernel
(with its dither, conditioning, log-kind and feature-kind branches and its
bf16x3 form), its fused resample, the feature tail, and the polyphase
resampler; `extract_batch` keeps the caller's TF32 setting.

Every test here is marked `gpu` and skips without a CUDA card (the kernel has
no CPU mode). The module imports no jax, so it also runs where only the
port's dependencies are installed; tests/conftest.py imports jax, so on such
a machine run it as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Gates: `mfcc_tpu_torch.testing` (those of
tests/test_pallas_kernels.py::test_kernel_matches_jnp_twin for the prefix,
each log kind taken to natural log; 1e-5 of the row's max |x| for the
resampler; 8e-4 for resampled features; 5e-4 / 1e-4 for Kaldi mfcc / fbank
features; the family gates of PLP, spectrogram and SSC prefixes and
features; the feature tail's max(2e-4, 2e-5·max|f|) with near-constant CMVN
columns held before the division; the bf16x3 route's 1e-3 on loud bins).
"""

import re

import numpy as np
import pytest
import torch

from mfcc_tpu.testing.golden import golden_signals
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.kernels import resample as rs_kernel
from mfcc_tpu_torch.kernels import tail
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
    # a bf16x3 matrix over the card's memory (n_fft = frame length =
    # 131,072: 68.7 GB, folded from 137.4 GB of float64) raises before it is
    # built or launched; n_fft 7001, refused before, runs in the default form
    before = frontend.launches
    with pytest.raises(NotImplementedError, match="over the card's"):
        frontend.logmel_prefix(audio, lengths, cfg.replace(n_fft=131072, win_len_s=131072 / 16000),
                               dft_passes="bf16x3")
    assert frontend.launches == before
    c7001 = cfg.replace(n_fft=7001)
    got = frontend.logmel_prefix(audio, lengths, c7001)
    torch.cuda.synchronize()
    assert frontend.launches == before + 1
    want = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), c7001.replace(dtype="float64"))
    assert_prefix_close(got, want, c7001.n_mels)
    # centered framing of resampled rows, refused before: the split route
    # (resample.cu, then the plain form's centered staging), counted, within
    # the prefix gates of the float64 plain version
    w48 = NAMED_CONFIGS["whisper80"].replace(input_sample_rate=48000)
    before = (rs_kernel.launches, frontend.launches, frontend.split_launches, frontend.resample_launches)
    got = frontend.logmel_prefix(audio, lengths, w48)
    torch.cuda.synchronize()
    after = (rs_kernel.launches, frontend.launches, frontend.split_launches, frontend.resample_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 0)
    want = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), w48.replace(dtype="float64"))
    assert_prefix_close(got, want, w48.n_mels, w48.log_kind)


def test_extract_batch_on_card_matches_cpu():
    _card()
    cfg = NAMED_CONFIGS["classic13_deltas"]
    b = _pcm_batch(cfg)
    before = (frontend.launches, tail.tail_launches)
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    assert feat.device.type == "cuda"
    assert (frontend.launches, tail.tail_launches) == (before[0] + 1, before[1] + 1)
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
    with pytest.raises(ValueError, match="contiguous"):
        resample.resample_batch(x[:, ::2], 48000, 16000)
    # 16000 -> 15999, refused before (its 1.34 MB tap table): the taps read
    # from device memory
    g = np.random.default_rng(14)
    x = torch.as_tensor((g.standard_normal((2, 4800)) * 3000).astype(np.float32), device=dev)
    before = (rs_kernel.launches, rs_kernel.global_tap_launches)
    got = resample.resample_batch(x, 16000, 15999)
    torch.cuda.synchronize()
    assert (rs_kernel.launches, rs_kernel.global_tap_launches) == (before[0] + 1, before[1] + 1)
    err = testing.resample_error(got, rs_kernel.resample_reference(x, 16000, 15999), x)
    assert err < testing.RESAMPLE_KERNEL_REL_ROWMAX, err


@pytest.mark.parametrize("config_name,blocks", [("mfcc39_48k", 3), ("mfcc39_44k", 2)])
def test_fused_resample_blocks_an_sm(config_name, blocks):
    """The fused form's int16 instantiation holds three blocks an SM at 48
    kHz and two at 44.1 kHz, with no spills and at most 80 registers (the
    FFT forms' launch bounds); float32 rows take fewer blocks, no fewer
    than one; resample.cu spills nothing, and its layout is the one
    `resample.smem_bytes` mirrors."""
    _card()
    cfg = NAMED_CONFIGS[config_name]
    info = frontend.kernel_info(cfg, True)
    assert info["blocks_per_sm"] >= blocks, info
    assert info["local_bytes"] == 0 and info["registers"] <= 80, info
    f32 = frontend.kernel_info(cfg, False)
    assert 1 <= f32["blocks_per_sm"] <= info["blocks_per_sm"] and f32["local_bytes"] == 0, f32
    rs = rs_kernel.kernel_info(cfg.input_sample_rate, cfg.sample_rate)
    assert rs["local_bytes"] == 0 and rs["blocks_per_sm"] >= 1, rs
    assert rs["smem_bytes"] == rs_kernel.smem_bytes(*resample.ratio(cfg.input_sample_rate, 16000))


@pytest.mark.parametrize("sr_in", [15999, 192000])
def test_fused_resample_over_budget_raises(sr_in):
    """A ratio whose fused layout does not fit the block (15999 Hz input: a
    16,000 x 21 tap table; 192 kHz input: its window), which raised before,
    takes the split route, picked by the layout mirror before any launch:
    resample.cu once (global taps at 15999 Hz), the plain form once, the
    fused form never; the prefix within its gates of the plain version,
    int16 ≡ float32 bitwise, and extract_batch within 8e-4 of the CPU
    chain."""
    dev = _card()
    cfg = NAMED_CONFIGS["mfcc39_48k"].replace(input_sample_rate=sr_in)
    assert frontend.layout_reason(cfg) is None and frontend.resample_route(cfg) == "split"
    assert frontend.smem_bytes(cfg, int16=False) > rs_kernel.SMEM_BUDGET_BYTES
    g = np.random.default_rng(sr_in)
    n = sr_in * 2
    audio = torch.as_tensor((g.standard_normal((3, n)) * 3000).astype(np.int16), device=dev)
    lengths = torch.tensor([n, n - 4001, 997], dtype=torch.int32, device=dev)
    before = (frontend.launches, frontend.resample_launches, rs_kernel.launches)
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert (frontend.launches, frontend.resample_launches, rs_kernel.launches) == (
        before[0] + 1, before[1], before[2] + 1)
    assert_prefix_close(got, frontend.logmel_prefix_reference(audio, lengths, cfg), cfg.n_mels)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    feat, mask = chain.extract_batch(audio, lengths, cfg)
    cpu, cpu_mask = chain.extract_batch(audio.cpu(), lengths.cpu(), cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    testing.assert_resampled_features_close(feat, cpu)


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


BRANCHES = [
    ("kaldi_mfcc", {"dither": 1.0}),
    ("kaldi_mfcc", {}),
    ("kaldi_fbank", {}),
    ("kaldi_mfcc", {"energy_source": "windowed_frame", "dither": 1.0}),
    ("logmel80", {}),
    ("logmel80", {"log_kind": "db"}),
    ("classic13_deltas", {"dither": 0.5}),
    ("mfcc39_48k", {"dither": 0.5}),
    ("kaldi_mfcc", {"input_sample_rate": 48000, "dither": 1.0}),
    ("kaldi_plp", {}),
    ("kaldi_spectrogram", {}),
    ("ssc26", {}),
    ("ssc26", {"input_sample_rate": 48000}),
    ("kaldi_plp", {"dither": 1.0}),
]
BRANCH_IDS = ["kaldi_mfcc_dither", "kaldi_mfcc", "kaldi_fbank", "windowed_energy_dither",
              "logmel80_ln_stab", "logmel80_db", "classic13_deltas_dither", "mfcc39_48k_dither",
              "kaldi_mfcc_48k_dither", "kaldi_plp", "kaldi_spectrogram", "ssc26", "ssc26_48k",
              "kaldi_plp_dither"]


def _branch_counts():
    return (frontend.launches + frontend.resample_launches, frontend.dither_launches,
            frontend.conditioning_launches, frontend.plp_launches,
            frontend.spectrogram_launches, frontend.ssc_launches)


@pytest.mark.parametrize("name,overrides", BRANCHES, ids=BRANCH_IDS)
def test_kernel_branches_match_reference(name, overrides):
    """Each dither, conditioning, log-kind and feature-kind branch ≡ its
    plain version; int16 ≡ float32 rows, dirty tails ≡ clean and two runs,
    bitwise."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    sr = cfg.input_sample_rate or cfg.sample_rate
    sigs = golden_signals(sr)
    b = pad_batch([np.round(sigs[n] * 3000) for n in SIGNALS], cfg, dtype="int16")
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    before = _branch_counts()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    kind = frontend.feature_kind(cfg)
    assert _branch_counts() == (
        before[0] + 1, before[1] + (cfg.dither > 0), before[2] + chain.needs_conditioning(cfg),
        before[3] + (kind == "plp"), before[4] + (kind == "spectrogram"),
        before[5] + (kind == "ssc"))
    assert_prefix_close(got, frontend.logmel_prefix_reference(audio, lengths, cfg), cfg.n_mels,
                        cfg.log_kind, cfg.features)
    t = torch.arange(audio.shape[1], device=dev)[None]
    dirty = torch.where(t < lengths[:, None], audio, 12345)
    assert torch.equal(got, frontend.logmel_prefix(dirty, lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))


def test_dithered_utterance_at_two_rows():
    dev = _card()
    cfg = NAMED_CONFIGS["kaldi_mfcc"].replace(dither=1.0)
    g = np.random.default_rng(19)
    u = (g.standard_normal(12000) * 300).astype(np.float32)
    b = pad_batch([u, g.standard_normal(16000) * 300, u], cfg)
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    got = frontend.logmel_prefix(audio, lengths, cfg)
    nv = cfg.num_frames(12000)
    assert torch.equal(got[0, :nv], got[2, :nv])
    other = frontend.logmel_prefix(audio, lengths, cfg.replace(dither_seed=1))
    assert not torch.equal(got[0, :nv], other[0, :nv])


def test_drop_framing_of_a_short_batch_launches_nothing():
    dev = _card()
    cfg = NAMED_CONFIGS["kaldi_mfcc"].replace(dither=1.0)
    audio = torch.zeros((3, 399), dtype=torch.int16, device=dev)
    lengths = torch.tensor([399, 1, 0], dtype=torch.int32, device=dev)
    before = (frontend.launches, frontend.dither_launches, frontend.conditioning_launches)
    out = frontend.logmel_prefix(audio, lengths, cfg)
    assert tuple(out.shape) == (3, 0, cfg.n_mels + 1) and out.device.type == "cuda"
    assert (frontend.launches, frontend.dither_launches, frontend.conditioning_launches) == before
    feat, mask = chain.extract_batch(audio, lengths, cfg)
    assert tuple(feat.shape) == (3, 0, cfg.feat_dim) and tuple(mask.shape) == (3, 0)


def test_conditioning_of_frames_longer_than_nfft():
    """kaldi_mfcc with 40 ms frames (L = 640 > n_fft = 512): all L samples
    conditioned, the first 512 transformed, as rfft(n=512) truncates."""
    dev = _card()
    cfg = NAMED_CONFIGS["kaldi_mfcc"].replace(win_len_s=0.040, n_fft=512)
    assert chain.unsupported_reason(cfg) is None
    b = _pcm_batch(cfg)
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    for c in (cfg, cfg.replace(energy_source="windowed_frame", dither=1.0)):
        got = frontend.logmel_prefix(audio, lengths, c)
        assert_prefix_close(got, frontend.logmel_prefix_reference(audio, lengths, c), c.n_mels,
                            c.log_kind)
    before = frontend.conditioning_launches
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    assert frontend.conditioning_launches == before + 1
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    valid = torch.as_tensor(b.lengths) >= cfg.frame_length
    testing.assert_kaldi_features_close(feat.cpu()[valid], cpu[valid], cfg)


@pytest.mark.parametrize("config_name", ["kaldi_mfcc", "kaldi_fbank", "logmel80"])
def test_extract_batch_kaldi_and_logmel80_on_card_match_cpu(config_name):
    """Kaldi features are gated on well-conditioned signals only: the
    chirp's quiet bins sit at the fp32 floor of any two implementations
    (docs/ACCURACY.md finding 5). logmel80 takes the two-regime gate, which
    covers quiet bins, so it keeps the chirp."""
    _card()
    cfg = NAMED_CONFIGS[config_name]
    if config_name == "kaldi_mfcc":
        cfg = cfg.replace(dither=1.0)
    names = ("noise", "speechish", "short") + (("chirp",) if config_name == "logmel80" else ())
    sigs = golden_signals()
    b = pad_batch([np.round(sigs[n] * 3000) for n in names], cfg, dtype="int16")
    before = frontend.launches
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    assert feat.device.type == "cuda" and frontend.launches == before + 1
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    valid = torch.as_tensor(b.lengths) >= cfg.frame_length
    if cfg.features == "logmel" and cfg.log_kind == "ln_stab":
        testing.assert_logmel_close(feat.cpu()[valid], cpu[valid], cfg.log_kind)
    else:
        testing.assert_kaldi_features_close(feat.cpu()[valid], cpu[valid], cfg)


def test_spectrogram_stages_no_matrix():
    """kaldi_spectrogram's identity projection stages no [257, 257] matrix
    (264 KB, over the block's 227 KB): its launch takes ~50 KB and runs."""
    dev = _card()
    cfg = NAMED_CONFIGS["kaldi_spectrogram"]
    assert 257 * 257 * 4 > rs_kernel.SMEM_BUDGET_BYTES
    assert frontend.smem_bytes(cfg) < 64 * 1024
    audio = torch.zeros((2, 16000), dtype=torch.int16, device=dev)
    lengths = torch.tensor([16000, 9000], dtype=torch.int32, device=dev)
    out = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (2, cfg.num_frames(16000), 258)
    eps = torch.tensor(cfg.log_eps, dtype=torch.float32)
    assert torch.allclose(out[..., :257].cpu(), torch.log(eps), rtol=1e-6)
    assert bool((out[..., 257].cpu() == eps).all())


@pytest.mark.parametrize("config_name", ["kaldi_plp", "kaldi_spectrogram", "ssc26"])
def test_extract_batch_families_on_card_match_cpu(config_name):
    """PLP, spectrogram and SSC features on the card ≡ the CPU chain within
    the family's fp32 gate, one front-end launch with the family's branch."""
    _card()
    cfg = NAMED_CONFIGS[config_name]
    names = ("noise", "speechish", "short")
    sigs = golden_signals()
    b = pad_batch([np.round(sigs[n] * 3000) for n in names], cfg, dtype="int16")
    counter = f"{cfg.features}_launches"
    before = (frontend.launches, getattr(frontend, counter))
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    assert feat.device.type == "cuda"
    assert (frontend.launches, getattr(frontend, counter)) == (before[0] + 1, before[1] + 1)
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    valid = torch.as_tensor(b.lengths) >= cfg.frame_length
    testing.assert_family_features_close(feat.cpu()[valid], cpu[valid], cfg.features)


def test_layout_over_the_block_budget_raises():
    """What is still refused raises before the launch: a bf16x3 matrix over
    the card's memory (n_fft = frame length = 131,072); 60,000 filters,
    refused before (over the packed table's filter field), launch in the
    default route ("gather_sums") and in bf16x3 ("gather_out"), and so does
    the bf16x3 opt-in at n_fft 4096 (over the block while it staged the
    power rows of every bin, now in its "pass" plan); n_fft 7,001 (refused
    before: the gather plan's Bluestein rows of P = 12,288 and its packed
    bands, 275,360 B) fits with the bands read from device memory (222,384
    B) and launches; n_fft 2048 at 26 filters, over it while the mel matrix
    was staged dense, fits with the packed bands, and 4096 (420,160 B in the
    warp plan) in the block plan."""
    dev = _card()
    cfg = NAMED_CONFIGS["classic13"].replace(n_fft=7001)
    assert frontend.smem_bytes(cfg.replace(n_fft=5393)) <= rs_kernel.SMEM_BUDGET_BYTES
    assert frontend.smem_bytes(cfg) == 222384 and frontend.fft_plan(cfg) == "gather_bands"
    assert frontend.smem_bytes(cfg.replace(n_fft=2048)) <= rs_kernel.SMEM_BUDGET_BYTES
    assert frontend.smem_bytes(cfg.replace(n_fft=4096)) <= rs_kernel.SMEM_BUDGET_BYTES
    assert frontend.smem_bytes(cfg.replace(n_fft=4096), "bf16x3") <= rs_kernel.SMEM_BUDGET_BYTES
    audio = torch.zeros((1, 16000), dtype=torch.int16, device=dev)
    lengths = torch.tensor([16000], dtype=torch.int32, device=dev)
    before = frontend.launches
    wide = cfg.replace(n_fft=131072, win_len_s=131072 / 16000)
    with pytest.raises(NotImplementedError, match="over the card's"):
        frontend.logmel_prefix(audio, lengths, wide, dft_passes="bf16x3")
    assert frontend.launches == before
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert frontend.launches == before + 1
    got = frontend.logmel_prefix(audio, lengths, cfg.replace(n_fft=4096), dft_passes="bf16x3")
    torch.cuda.synchronize()
    assert frontend.launches == before + 2 and bool(torch.isfinite(got).all())
    eps = torch.tensor(cfg.log_eps, dtype=torch.float32)
    assert torch.equal(got[..., cfg.n_mels].cpu(), eps.expand(got.shape[:2]))  # zero rows: energy eps
    many = NAMED_CONFIGS["classic13"].replace(n_mels=60000)
    for passes in ("radix4", "bf16x3"):
        got = frontend.logmel_prefix(audio, lengths, many, dft_passes=passes)
        torch.cuda.synchronize()
        assert got.shape[-1] == 60001 and bool(torch.isfinite(got).all())
    assert frontend.launches == before + 4


def _counts():
    return (frontend.launches, frontend.centered_launches, frontend.block_fft_launches,
            frontend.dither_launches, frontend.bluestein_launches)


def test_whisper80_at_30_s_matches_reference():
    """whisper80 at b4 × 30 s int16 (Whisper's padded chunk, lengths
    480,000 and shorter, multi-wrap rows): one launch with the centered
    branch (the Stockham form at 200 = 8·5·5 points); the prefix within the gates of the float64 plain
    version (its narrow filters' lanes under the per-bin gate), features
    within 5e-5 of the CPU chain and the mask equal."""
    dev = _card()
    cfg = NAMED_CONFIGS["whisper80"]
    g = np.random.default_rng(23)
    utts = [g.standard_normal(n) * 3000 for n in (480000, 480000 - 1713, 801, 90)]
    b = pad_batch(utts, cfg, bucket_len=480000, dtype="int16")
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    before = _counts()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2], before[3], before[4])
    assert got.shape == (4, cfg.num_frames(b.audio.shape[1]), 81)
    want = frontend.logmel_prefix_reference(audio, lengths, cfg.replace(dtype="float64"))
    narrow = testing.narrow_lanes(chain.device_constants(cfg, torch.device("cpu"), torch.float64)["mel"])
    assert_prefix_close(got, want, cfg.n_mels, cfg.log_kind, narrow=narrow)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    testing.assert_whisper_features_close(feat, cpu)


CENTERED = [
    ("kaldi_mfcc", {"frame_tail": "center", "dither": 1.0}),
    ("classic13", {"frame_tail": "center", "dither": 1.0}),
    ("classic13", {"frame_tail": "center_reflect"}),
    ("classic13", {"n_fft": 404}),
    ("classic13", {"n_fft": 480}),
    ("whisper80", {"dither": 0.5}),
    ("classic13", {"n_fft": 2048}),
    ("classic13", {"n_fft": 551}),
    ("kaldi_mfcc", {"n_fft": 405, "frame_tail": "center", "dither": 1.0}),
    ("classic13", {"n_fft": 1102}),
    ("classic13", {"n_fft": 4096}),
    ("classic13", {"n_fft": 2501}),
    ("kaldi_mfcc", {"n_fft": 2160, "frame_tail": "center", "dither": 1.0}),
    ("logmel80", {"sample_rate": 22050, "n_fft": 2048, "win_len_s": 2048 / 22050,
                  "hop_s": 512 / 22050, "n_mels": 128}),
]
CENTERED_IDS = ["kaldi_center_dither", "center_preemph_dither", "center_reflect_preemph",
                "bluestein_404", "mixed_radix_480", "whisper80_dither", "stockham_2048",
                "bluestein_odd_551", "bluestein_odd_405_center_dither", "block_fft_1102",
                "block_fft_4096", "block_fft_global_odd_2501", "block_fft_2160_center_dither",
                "block_fft_librosa_2048"]


@pytest.mark.parametrize("name,overrides", CENTERED, ids=CENTERED_IDS)
def test_centered_and_dft_forms_match_reference(name, overrides):
    """Centered staging in both modes (source-index pre-emphasis and noise),
    the Bluestein form (404: P = 512; odd 551 and 405), the block FFT plan
    where the warp plan's rows do not fit (1102, 4096, 2501 with its tables
    in device memory, 2160 centered with conditioning and dither, librosa's
    22.05 kHz framing), a radix-3 Stockham size and
    n_fft 2048 (1,024 = 8·8·8·2 points, 1,915 packed weights) against the
    plain version computed on the CPU in float64 (the card's float64 rfft
    at some odd sizes is not), rows down to 90 samples (multi-wrap); int16 ≡
    float32, two runs equal."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    g = np.random.default_rng(29)
    utts = [g.standard_normal(n) * 3000 for n in (16000, 12345, 801, 401, 250, 90)]
    b = pad_batch(utts, cfg, bucket_len=16000, dtype="int16")
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    form = frontend.dft_form(cfg)
    before = _counts()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + chain.centered(cfg),
                         before[2] + (frontend.fft_plan(cfg) != "warp"), before[3] + (cfg.dither > 0),
                         before[4] + (form == "bluestein"))
    narrow = None
    if cfg.logmel_norm == "whisper":
        narrow = testing.narrow_lanes(chain.device_constants(cfg, torch.device("cpu"), torch.float64)["mel"])
    want = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), cfg.replace(dtype="float64"))
    assert_prefix_close(got, want, cfg.n_mels, cfg.log_kind, narrow=narrow)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))


def test_rows_over_the_reference_slab_bound():
    """classic13_deltas at b2 × 140 s (2.24 M samples a row, over the 8 MiB
    slab that sends the TPU kernel to its view mode): the prefix within the
    gates of the plain version, features within 5e-4 of the CPU chain."""
    dev = _card()
    cfg = NAMED_CONFIGS["classic13_deltas"]
    g = np.random.default_rng(31)
    n = 140 * 16000
    b = pad_batch([g.standard_normal(n) * 3000, g.standard_normal(n - 16001) * 3000], cfg,
                  dtype="int16")
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    got = frontend.logmel_prefix(audio, lengths, cfg)
    assert_prefix_close(got, frontend.logmel_prefix_reference(audio, lengths, cfg), cfg.n_mels)
    feat, _ = chain.extract_batch(b.audio, b.lengths, cfg)
    cpu, _ = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert_features_close(feat, cpu)


# one 16 kHz frame hop is 160 samples: n_valid = 31, 32, 33 and 64 frames at
# 5,200, 5,360, 5,361 and 10,480 samples ("pad" framing), the tile edges
TAIL_LENGTHS = [0, 1, 399, 400, 401, 5200, 5360, 5361, 10480, 16000]
TAIL_CASES = [
    ("classic13_deltas", {}),
    ("classic13_deltas", {"cmvn": "utterance"}),
    ("classic13_deltas", {"cmvn": "utterance", "cmvn_var_norm": False}),
    ("classic13", {"deltas": 1}),
    ("classic13", {"append_energy": False}),
    ("kaldi_mfcc", {"energy_floor": 1e-3}),
    ("kaldi_mfcc", {"deltas": 2, "cmvn": "utterance", "dither": 1.0}),
]
TAIL_IDS = ["deltas2", "deltas2_cmvn", "deltas2_cmvn_mean", "deltas1", "no_energy", "kaldi_floor",
            "kaldi_deltas_cmvn_dither"]


def _tail_rows(cfg):
    """Random rows at the tile-edge lengths, a zero row, and a 100 Hz tone
    (its period is the hop, so its frames are near-constant), int16."""
    g = np.random.default_rng(37)
    utts = [g.standard_normal(n) * 3000 for n in TAIL_LENGTHS]
    utts += [np.zeros(16000), 3000 * np.sin(2 * np.pi * 100 * np.arange(16000) / 16000)]
    return pad_batch(utts, cfg, bucket_len=16000, dtype="int16")


@pytest.mark.parametrize("name,overrides", TAIL_CASES, ids=TAIL_IDS)
def test_feature_tail_matches_reference(name, overrides):
    """The tail kernel ≡ its plain version on the front-end's own prefix:
    tile-edge n_valid, n_valid 0 and 1, a zero row and a near-constant row;
    masks equal, pad rows exactly 0; one tail launch (and one CMVN launch)."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    b = _tail_rows(cfg)
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    st = frontend.fused_logmel_stages(audio, lengths, cfg)
    prefix, nv = st["prefix"], st["n_valid"]
    before = (tail.tail_launches, tail.tail_cmvn_launches)
    got = tail.feature_tail(prefix, nv, cfg)
    torch.cuda.synchronize()
    assert (tail.tail_launches, tail.tail_cmvn_launches) == (
        before[0] + 1, before[1] + (cfg.cmvn == "utterance"))
    want = tail.feature_tail_reference(prefix, nv, cfg)
    scale = None
    if cfg.cmvn == "utterance" and cfg.cmvn_var_norm:
        pre = tail.feature_tail_reference(prefix, nv, cfg.replace(cmvn="off"))
        scale = testing.cmvn_column_scale(pre, nv, cfg.cmvn_eps)
    errs = testing.tail_errors(got, want, scale)
    assert not testing.tail_failures(errs), errs
    pad = st["frame_mask"] == 0
    assert bool((got[pad] == 0).all()) and int(pad.sum()) > 0


@pytest.mark.parametrize("config_name", ["classic13", "classic13_deltas", "classic13_deltas_gcmvn",
                                         "mfcc39_48k", "mfcc39_44k", "kaldi_mfcc"])
def test_extract_batch_launches_the_tail(config_name):
    """extract_batch for each mfcc named config: one front-end launch (plain
    or fused resample) and one tail launch; features within the config's
    gate of the CPU chain, masks equal."""
    _card()
    cfg = NAMED_CONFIGS[config_name]
    sigs = golden_signals(cfg.input_sample_rate or cfg.sample_rate)
    b = pad_batch([np.round(sigs[n] * 3000) for n in ("noise", "speechish", "short")], cfg,
                  dtype="int16")
    before = (frontend.launches + frontend.resample_launches, tail.tail_launches)
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    torch.cuda.synchronize()
    assert (frontend.launches + frontend.resample_launches, tail.tail_launches) == (
        before[0] + 1, before[1] + 1)
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    assert bool((feat[mask == 0] == 0).all())
    if chain.resamples(cfg):
        testing.assert_resampled_features_close(feat, cpu)
    elif cfg.frame_tail == "drop":
        valid = torch.as_tensor(b.lengths) >= cfg.frame_length
        testing.assert_kaldi_features_close(feat.cpu()[valid], cpu[valid], cfg)
    else:
        assert_features_close(feat, cpu)


def _count_lengths(cfg, T: int) -> list[int]:
    """Lengths at the edges of cfg's frame count, in the rows' own samples:
    0, 1, a frame length and its neighbours, a hop's, the first tile's span
    and its neighbours, T - 1, T and a negative length."""
    r = (cfg.input_sample_rate or cfg.sample_rate) / cfg.sample_rate
    L, S = round(cfg.frame_length * r), round(cfg.frame_step * r)
    span = round((31 * cfg.frame_step + cfg.frame_length) * r)
    return [0, 1, L - 1, L, L + 1, S - 1, S, S + 1, span - 1, span, span + 1, T - 1, T, -1]


COUNT_CASES = [
    ("classic13_deltas", {}, "radix4"),
    ("classic13_deltas", {}, "bf16x3"),
    ("classic13", {"drop_last_frame": True}, "radix4"),
    ("kaldi_mfcc", {}, "radix4"),
    ("kaldi_mfcc", {"dither": 1.0}, "radix4"),
    ("kaldi_mfcc", {"dither": 1.0}, "bf16x3"),
    ("classic13", {"frame_tail": "center"}, "radix4"),
    ("whisper80", {}, "radix4"),
    ("classic13", {"frame_tail": "center_reflect"}, "radix4"),
    ("mfcc39_48k", {}, "radix4"),
    ("mfcc39_44k", {}, "radix4"),
    ("mfcc39_48k", {"frame_tail": "drop", "drop_last_frame": True}, "radix4"),
]
COUNT_IDS = ["pad", "pad_bf16x3", "pad_drop_last", "drop", "drop_dither", "drop_dither_bf16x3",
             "center", "center_reflect_drop_last", "center_reflect", "resampled_48k",
             "resampled_44k", "resampled_48k_drop_drop_last"]


@pytest.mark.parametrize("name,overrides,passes", COUNT_CASES, ids=COUNT_IDS)
def test_kernel_counts_and_mask_equal_the_chains(name, overrides, passes):
    """The front-end kernel's n_valid and frame mask (`logmel_prefix_counts`)
    bitwise equal to chain.num_valid_frames / chain.frame_mask of the same
    card lengths (of their output lengths for resampled rows), at each
    framing's edge lengths, through each form's launch."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    T = cfg.input_sample_rate or cfg.sample_rate  # one second
    lens = torch.tensor(_count_lengths(cfg, T), dtype=torch.int32, device=dev)
    g = torch.Generator(dev).manual_seed(41)
    audio = torch.randint(-3000, 3000, (lens.numel(), T), dtype=torch.int16, device=dev, generator=g)
    prefix, nv, mask = frontend.logmel_prefix_counts(audio, lens, cfg, dft_passes=passes)
    want_nv, want_mask = frontend.frame_counts_reference(lens, cfg, prefix.shape[1])
    assert nv.device.type == mask.device.type == "cuda"
    assert torch.equal(nv, want_nv) and torch.equal(mask, want_mask)
    assert torch.equal(prefix, frontend.logmel_prefix(audio, lens, cfg, dft_passes=passes))


TAIL_EDGE_CASES = [
    ("classic13_deltas", {}),
    ("classic13_deltas", {"cmvn": "utterance"}),
    ("classic13", {"deltas": 1}),
    ("kaldi_mfcc", {}),
    ("classic13_deltas", {"n_mels": 150, "n_ceps": 140}),
]
TAIL_EDGE_IDS = ["deltas2", "deltas2_cmvn", "generic_deltas1", "kaldi_even_rows", "generic_tile64"]


@pytest.mark.parametrize("F", [127, 128, 129, 257])
@pytest.mark.parametrize("name,overrides", TAIL_EDGE_CASES, ids=TAIL_EDGE_IDS)
def test_feature_tail_at_its_tile_edges(name, overrides, F):
    """The tail kernel against its plain version with F and n_valid at its
    tile's edges (tail.plan: 128 frames, 64 for the wide generic shape),
    with utterance CMVN, the generic instantiation, even prefix rows, and a
    prefix that is not 16-byte aligned (the scalar staging); pad rows 0."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    M1 = cfg.n_mels + 1
    nvs = sorted(v for v in {0, 1, 2, 63, 64, 65, 127, 128, 129, F} if v <= F)
    g = torch.Generator(dev).manual_seed(F)
    flat = torch.randn(len(nvs) * F * M1 + 1, generator=g, device=dev)
    for prefix in (flat[:-1].view(len(nvs), F, M1), flat[1:].view(len(nvs), F, M1)):
        prefix[..., -1] = prefix[..., -1].abs() * 1e3
        nv = torch.tensor(nvs, dtype=torch.int32, device=dev)
        got = tail.feature_tail(prefix, nv, cfg)
        want = tail.feature_tail_reference(prefix, nv, cfg)
        scale = None
        if cfg.cmvn == "utterance":
            pre = tail.feature_tail_reference(prefix, nv, cfg.replace(cmvn="off"))
            scale = testing.cmvn_column_scale(pre, nv, cfg.cmvn_eps)
        errs = testing.tail_errors(got, want, scale)
        assert not testing.tail_failures(errs), errs
        pad = torch.arange(F, device=dev)[None, :] >= nv[:, None]
        assert bool((got[pad] == 0).all())


@pytest.mark.parametrize("name", ["kaldi_mfcc", "classic13"])
def test_dither_staged_in_the_signal_row(name):
    """With dither 1.0 (frame mode at kaldi_mfcc, signal pre-emphasis at
    classic13) the kernel's prefix against its plain version on rows over
    several chunks and tiles, int16 ≡ float32 and two runs bitwise; the
    dithered layout keeps three blocks an SM."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(dither=1.0)
    n = 48000
    lens = [n - 571 * i for i in range(6)] + [0, 1, 399, 400, 401, 5359, 5360, 5361]
    g = np.random.default_rng(43)
    b = pad_batch([g.standard_normal(x) * 3000 for x in lens], cfg, bucket_len=n, dtype="int16")
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    got = frontend.logmel_prefix(audio, lengths, cfg)
    want = frontend.logmel_prefix_reference(audio, lengths, cfg)
    valid = lengths >= cfg.frame_length
    assert_prefix_close(got[valid], want[valid], cfg.n_mels, cfg.log_kind)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))
    assert frontend.kernel_info(cfg)["blocks_per_sm"] >= 3


def test_extract_batch_step_runs_two_device_kernels():
    """One classic13_deltas extract_batch with int16 rows and int32 lengths
    on the card runs the front-end kernel and the tail kernel and no other
    device kernel (the profiler's device events; a trace that lost records
    is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    cfg = NAMED_CONFIGS["classic13_deltas"]
    b = _pcm_batch(cfg)
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev).to(torch.int32)
    for _ in range(2):
        chain.extract_batch(audio, lengths, cfg)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chain.extract_batch(audio, lengths, cfg)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        assert len(names) <= 2, names
        if len(names) == 2:
            break
    assert sorted("logmel_kernel" in x for x in names) == [False, True], names
    assert any("tail_kernel" in x for x in names), names


BF16X3 = [
    ("classic13", {}),
    ("kaldi_mfcc", {"dither": 1.0, "n_fft": 404}),
    ("whisper80", {}),
    ("kaldi_plp", {}),
    ("ssc26", {}),
    ("kaldi_mfcc", {"win_len_s": 0.040, "n_fft": 512, "energy_source": "windowed_frame"}),
    ("classic13", {"n_fft": 1024}),
    ("classic13", {"n_fft": 2048, "frame_tail": "center"}),
]
BF16X3_IDS = ["classic13", "kaldi_404_dither", "whisper80", "kaldi_plp", "ssc26", "frames_over_n_fft",
              "n_fft_1024_two_stages", "n_fft_2048_32_frames_centered"]


@pytest.mark.parametrize("name,overrides", BF16X3, ids=BF16X3_IDS)
def test_bf16x3_matches_reference(name, overrides):
    """The bf16x3 form (wgmma over the ring; 64 frames a block, 32 with the
    upper rows zero at n_fft 2048, two ring stages at 1024) ≡ its plain
    version (loud log-mel bins within 1e-3, the other prefix gates as for
    every form); classic13's loud bins within 1e-3 of the float64 plain
    version; one launch, counted."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    g = np.random.default_rng(41)
    utts = [g.standard_normal(n) * 3000 for n in (16000, 12345, 801, 401, 90)]
    b = pad_batch(utts, cfg, bucket_len=16000, dtype="int16")
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    before = (frontend.launches, frontend.bf16x3_launches)
    got = frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")
    torch.cuda.synchronize()
    assert (frontend.launches, frontend.bf16x3_launches) == (before[0] + 1, before[1] + 1)
    want = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3")
    errs = testing.prefix_errors(got, want, cfg.n_mels, cfg.log_kind, cfg.features)
    assert not testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL), errs
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes="bf16x3"))
    if name == "classic13":
        f64 = frontend.logmel_prefix_reference(audio, lengths, cfg.replace(dtype="float64"))
        errs = testing.prefix_errors(got, f64, cfg.n_mels)
        assert errs["logmel_loud_max_abs"] < testing.BF16X3_LOUD_ATOL, errs


def test_bf16x3_form_runs_wgmma():
    """The bf16x3 instantiations' SASS holds HGMMA (wgmma) and the ring's
    bulk copies (UBLKCP), and no HMMA (mma.sync): 8 of the plain form and 8
    of the fused resample (int16 or float32 rows, dither, conditioning)."""
    import pathlib
    import subprocess

    from mfcc_tpu_torch.kernels import _build

    _card()
    lib, _ = _build.build("frontend")
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    # template arguments: the sample type, kResample, kDither, kCond, kBf16 and kBlock
    bf16 = [fn for fn in dump.split("Function : ")[1:]
            if re.search(r"logmel_kernelI[sf](?:Lb[01]E){3}Lb1ELb0EEEv", fn.split("\n", 1)[0])]
    assert len(bf16) == 16
    assert sum("Lb1ELb" in fn.split("\n", 1)[0].split("logmel_kernel", 1)[1][:8] for fn in bf16) == 8
    for fn in bf16:
        assert "HGMMA" in fn and "UBLKCP" in fn and "HMMA" not in fn.replace("HGMMA", "")


LIBROSA_8192 = dict(sample_rate=22050, n_fft=8192, win_len_s=8192 / 22050, hop_s=2048 / 22050, n_mels=128)
BF16X3_PLANS = [
    ("classic13", {"n_fft": 2245}, "gather"),
    ("classic13", {"n_fft": 4096}, "gather"),
    ("classic13", {"n_fft": 8192}, "gather"),
    ("kaldi_mfcc", {"dither": 1.0, "n_fft": 4096}, "gather"),
    ("ssc26", {"n_fft": 4096}, "gather"),
    ("kaldi_plp", {"n_fft": 4096}, "gather"),
    ("classic13", {"hop_s": 0.1}, "gather"),
    ("classic13", {"win_len_s": 1.1}, "gather"),
    ("kaldi_mfcc", {"dither": 1.0, "hop_s": 0.1, "frame_tail": "center"}, "gather"),
    ("kaldi_spectrogram", {"hop_s": 0.1}, "gather"),
    ("mfcc39_48k", {"hop_s": 0.1}, "gather"),
    ("classic13", {"n_fft": 24000}, "gather"),
    ("classic13", {"n_mels": 2000, "n_fft": 4096}, "gather_out"),
    ("ssc26", {"n_mels": 700, "n_fft": 16384}, "gather_out"),
    ("classic13", {"win_len_s": 0.01, "n_fft": 4096}, "pass"),
    ("classic13", {"n_fft": 32768}, "gather_bands"),
    ("logmel80", LIBROSA_8192, "gather_out"),
]
BF16X3_PLAN_IDS = ["gather_2245", "gather_4096", "gather_8192", "gather_kaldi_dither", "gather_ssc26",
                   "gather_kaldi_plp", "gather_hop", "gather_frames", "gather_kaldi_dither_centered",
                   "gather_spectrogram", "gather_split_48k", "gather_24000", "gather_out_2000", "gather_out_ssc_700",
                   "pass_10ms_4096", "gather_bands_32768", "gather_out_librosa_8192"]


@pytest.mark.parametrize("name,overrides,plan", BF16X3_PLANS, ids=BF16X3_PLAN_IDS)
def test_bf16x3_block_plans_match_reference(name, overrides, plan):
    """The bf16x3 form's block plans (`frontend.bf16_layout`: the tile's A in
    shared memory; A in the workspace, then the bands and the pass table,
    then the accumulators in device memory) ≡ their plain version at the
    bf16x3 gates; one launch counted by plan (resampled rows: resample.cu,
    then the plain form); int16 ≡ float32 and two runs bitwise; the
    instantiation at 384 threads without spills."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    at = frontend.feature_rate_config(cfg)
    assert frontend.bf16_layout(at)[0] == plan
    sr = cfg.input_sample_rate or cfg.sample_rate
    g = np.random.default_rng(43)
    utts = [g.standard_normal(n) * 3000 for n in (3 * sr, 2 * sr + 12345, 801, 90)]
    b = pad_batch(utts, cfg, bucket_len=3 * sr, dtype="int16")
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    counters = ("bf16x3_launches", f"bf16_{plan}_launches", "split_launches")
    before = [getattr(frontend, c) for c in counters]
    got = frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")
    torch.cuda.synchronize()
    split = int(frontend.resample_route(cfg, "bf16x3") == "split")
    assert [getattr(frontend, c) - n for c, n in zip(counters, before)] == [1, 1, split]
    want = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3")
    errs = testing.prefix_errors(got, want, cfg.n_mels, cfg.log_kind, cfg.features)
    assert not testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL), errs
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes="bf16x3"))
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3"))
    info = frontend.kernel_info(cfg, True, "bf16x3")
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1 and info["threads"] == 384, info


def test_bf16x3_block_plans_run_wgmma():
    """The bf16x3 block plans' 8 instantiations of `logmel_kernel_bf16` (the
    plain form: int16 or float32 rows, dither, conditioning) hold HGMMA, the
    ring's bulk copies and setmaxnreg's register moves, and no mma.sync."""
    import pathlib
    import subprocess

    from mfcc_tpu_torch.kernels import _build

    _card()
    lib, _ = _build.build("frontend")
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    block = [fn for fn in dump.split("Function : ")[1:]
             if re.search(r"logmel_kernel_bf16I[sf](?:Lb[01]E){2}EEv", fn.split("\n", 1)[0])]
    assert len(block) == 8
    for fn in block:
        assert "HGMMA" in fn and "UBLKCP" in fn and "USETMAXREG" in fn and "HMMA" not in fn.replace("HGMMA", "")


@pytest.mark.parametrize("n_fft", [404, 551])
def test_bluestein_form_through_extract_batch_and_the_fp32_route(n_fft):
    """classic13 at n_fft 404 and 551: extract_batch and
    fused_logmel_stages(dft_passes="fp32") each launch the Bluestein form
    once (the warp plan, no block plan); the prefix within the gates of the float64 plain
    version computed on the CPU, the features within 5e-4 of the CPU chain.
    (No pure tone: at n_fft 404 the CPU fp32 chain is itself 1.1e-3 from
    float64 on tone_offbin's quiet cepstra.)"""
    dev = _card()
    cfg = NAMED_CONFIGS["classic13"].replace(n_fft=n_fft)
    sigs = golden_signals()
    b = pad_batch([np.round(sigs[n] * 3000) for n in ("noise", "speechish", "short")], cfg,
                  dtype="int16")
    before = (frontend.bluestein_launches, frontend.block_fft_launches)
    feat, mask = chain.extract_batch(b.audio, b.lengths, cfg)
    torch.cuda.synchronize()
    assert (frontend.bluestein_launches, frontend.block_fft_launches) == (before[0] + 1, before[1])
    cpu, cpu_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    assert_features_close(feat, cpu)
    audio = torch.as_tensor(b.audio, device=dev)
    lengths = torch.as_tensor(b.lengths, device=dev)
    st = frontend.fused_logmel_stages(audio, lengths, cfg, dft_passes="fp32")
    torch.cuda.synchronize()
    assert (frontend.bluestein_launches, frontend.block_fft_launches) == (before[0] + 2, before[1])
    want = frontend.logmel_prefix_reference(torch.as_tensor(b.audio), torch.as_tensor(b.lengths),
                                            cfg.replace(dtype="float64"))
    assert_prefix_close(st["prefix"], want, cfg.n_mels)


def test_bf16x3_refused_in_the_fused_resample_form():
    """bf16x3 in the fused-resample form, refused before, runs: at 48 and
    44.1 kHz one fused launch that takes the bf16x3 branch, within the
    bf16x3 gates of its plain version, int16 ≡ float32 bitwise, no spills."""
    dev = _card()
    g = np.random.default_rng(15)
    for name in ("mfcc39_48k", "mfcc39_44k"):
        cfg = NAMED_CONFIGS[name]
        n = cfg.input_sample_rate * 2
        audio = torch.as_tensor((g.standard_normal((3, n)) * 3000).astype(np.int16), device=dev)
        lengths = torch.tensor([n, n - 3001, 1201], dtype=torch.int32, device=dev)
        assert frontend.resample_route(cfg, "bf16x3") == "fused"
        before = (frontend.resample_launches, frontend.bf16x3_launches, rs_kernel.launches)
        got = frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")
        torch.cuda.synchronize()
        assert (frontend.resample_launches, frontend.bf16x3_launches, rs_kernel.launches) == (
            before[0] + 1, before[1] + 1, before[2])
        want = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3")
        errs = testing.prefix_errors(got, want, cfg.n_mels)
        assert not testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL), errs
        assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes="bf16x3"))
        for int16 in (True, False):
            info = frontend.kernel_info(cfg, int16, "bf16x3")
            assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, info


@pytest.mark.parametrize("name,over", [
    ("whisper80", {"input_sample_rate": 48000}),
    ("classic13_deltas", {"frame_tail": "center", "input_sample_rate": 44100}),
    ("kaldi_mfcc", {"frame_tail": "center", "dither": 1.0, "input_sample_rate": 48000}),
    ("kaldi_plp", {"frame_tail": "center", "input_sample_rate": 48000}),
    ("kaldi_spectrogram", {"frame_tail": "center", "input_sample_rate": 48000}),
    ("ssc26", {"frame_tail": "center", "input_sample_rate": 48000}),
], ids=["whisper80_48k", "classic13_deltas_center_44k", "kaldi_mfcc_center_dither_48k",
        "kaldi_plp_center_48k", "kaldi_spectrogram_center_48k", "ssc26_center_48k"])
def test_centered_resampled_rows_take_the_split_route(name, over):
    """Centered framing of resampled rows: extract_batch launches resample.cu
    once, the plain form once (its centered branch, the dither branch once
    when dithering), the fused form never and, for mfcc, the tail once; the
    features within the family's gate of the CPU chain (8e-4 resampled,
    whisper80 5e-5), masks equal, two runs bitwise equal."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**over)
    sr = cfg.input_sample_rate
    g = np.random.default_rng(sr + len(name))
    pcm = (g.standard_normal((3, 2 * sr)) * 3000).astype(np.int16)
    lens = np.array([2 * sr, sr + 777, 1999], np.int32)
    pcm[np.arange(2 * sr)[None, :] >= lens[:, None]] = 0
    audio = torch.as_tensor(pcm, device=dev)
    lengths = torch.as_tensor(lens, device=dev)
    counts = lambda: (rs_kernel.launches, frontend.launches, frontend.resample_launches,  # noqa: E731
                      frontend.centered_launches, frontend.dither_launches, tail.tail_launches)
    before = counts()
    feat, mask = chain.extract_batch(audio, lengths, cfg)
    torch.cuda.synchronize()
    mfcc = cfg.features == "mfcc"
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0, 1, int(cfg.dither > 0), int(mfcc))
    cpu, cpu_mask = chain.extract_batch(pcm, lens, cfg, device="cpu")
    assert torch.equal(mask.cpu(), cpu_mask)
    if cfg.logmel_norm == "whisper":
        testing.assert_whisper_features_close(feat, cpu)
    elif mfcc:
        testing.assert_resampled_features_close(feat, cpu)
    else:
        testing.assert_family_features_close(feat, cpu, cfg.features)
    again, _ = chain.extract_batch(audio, lengths, cfg)
    assert torch.equal(feat, again)


@pytest.mark.parametrize("sr_in,sr_out,mode,tile", [
    (192000, 8000, "staged", 1120), (16000, 15999, "global_taps", 1792),
    (48000, 400, "global_all", 1792), (192000, 16000, "staged", 1792),
])
def test_resample_kernel_plans(sr_in, sr_out, mode, tile):
    """resample.cu at each plan: a reduced tile, the taps from device
    memory, the windows too; within 1e-5 of each row's max |x| of the plain
    version, counted by branch; int16 rows with lengths (`resample_rows`)
    ≡ the same rows in float32 bitwise, and within 1e-5 of
    `resample_rows_reference`, their output lengths equal."""
    dev = _card()
    assert rs_kernel.plan(*resample.ratio(sr_in, sr_out)) == (tile, mode)
    g = np.random.default_rng(sr_out)
    T = 3 * sr_in // 4 + 13
    x16 = torch.as_tensor((g.standard_normal((4, T)) * 3000).astype(np.int16), device=dev)
    x = x16.float()
    counts = lambda: (rs_kernel.launches, rs_kernel.reduced_tile_launches,  # noqa: E731
                      rs_kernel.global_tap_launches, rs_kernel.global_window_launches)
    before = counts()
    got = resample.resample_batch(x, sr_in, sr_out)
    torch.cuda.synchronize()
    want_d = (1, int(tile < rs_kernel.TILE_OUT), int(mode != "staged"), int(mode == "global_all"))
    assert tuple(a - b for a, b in zip(counts(), before)) == want_d
    err = testing.resample_error(got, rs_kernel.resample_reference(x, sr_in, sr_out), x)
    assert err < testing.RESAMPLE_KERNEL_REL_ROWMAX, err
    lengths = torch.tensor([T, T - 1, T // 3, 0], dtype=torch.int32, device=dev)
    y16, n16 = rs_kernel.resample_rows(x16, lengths, sr_in, sr_out)
    yf, nf = rs_kernel.resample_rows(x, lengths, sr_in, sr_out)
    wy, wn = rs_kernel.resample_rows_reference(x, lengths, sr_in, sr_out)
    assert torch.equal(y16, yf) and torch.equal(n16, nf) and torch.equal(n16, wn.to(torch.int32))
    assert testing.resample_error(y16, wy, x) < testing.RESAMPLE_KERNEL_REL_ROWMAX


def test_a_tail_layout_over_the_block_raises_on_the_card():
    """An mfcc config whose tiled tail with dct_aug staged is over the
    block's shared memory, refused before, runs on the card: 170 cepstra at
    delta window 8 and 200 at window 40 (with utterance CMVN) in the split
    plan, each of its 1 + deltas passes counted, against the plain version at the
    tail's gate, pad rows 0; extract_batch launches the front-end and the
    tail once each."""
    dev = _card()
    for over in (dict(n_mels=170, n_ceps=170, delta_window=8),
                 dict(n_mels=200, n_ceps=200, delta_window=40, cmvn="utterance")):
        cfg = NAMED_CONFIGS["classic13_deltas"].replace(**over)
        assert tail.plan(cfg)[0] == "split"
        g = np.random.default_rng(cfg.n_ceps)
        prefix = torch.as_tensor(g.standard_normal((3, 257, cfg.n_mels + 1)).astype(np.float32), device=dev)
        prefix[..., -1] = prefix[..., -1].abs() * 1e3
        nv = torch.tensor([257, 100, 0], dtype=torch.int32, device=dev)
        tail.tail_launches = tail.tail_split_launches = 0
        got = tail.feature_tail(prefix, nv, cfg)
        torch.cuda.synchronize()
        assert (tail.tail_launches, tail.tail_split_launches) == (1, 1 + cfg.deltas)
        errs = testing.tail_errors(got, tail.feature_tail_reference(prefix, nv, cfg))
        assert not testing.tail_failures(errs), errs
        assert bool((got[chain.frame_mask(nv, 257, torch.float32) == 0] == 0).all())
        audio = torch.as_tensor(np.round(g.standard_normal((2, 16000)) * 3000).astype(np.int16), device=dev)
        lengths = torch.tensor([16000, 8000], dtype=torch.int32, device=dev)
        frontend.launches = tail.tail_launches = 0
        feat, mask = chain.extract_batch(audio, lengths, cfg)
        torch.cuda.synchronize()
        assert (frontend.launches, tail.tail_launches) == (1, 1)
        assert bool(torch.isfinite(feat).all()) and bool((feat[mask == 0] == 0).all())


@pytest.mark.parametrize("M", [1100, 16385, 40000])
def test_tail_base_kernel_matches_reference(M):
    """The split's base past 1,024 filters (where the split takes the shape,
    from ~1,100 filters at 13 cepstra; tail_base_kernel: 64-frame
    tiles, each warp a compensated sum over its stretches, the warps' sums
    added in float64) on a front-end prefix: against the plain version at
    the tail's gate, pad rows 0, two runs bitwise, its launch counted; a
    prefix tensor that starts off the 16-byte boundary (a view one float
    in) gives the same features."""
    dev = _card()
    cfg = NAMED_CONFIGS["classic13_deltas"].replace(n_mels=M)
    assert tail.split_base(cfg) == "stretches"
    g = np.random.default_rng(M)
    audio = torch.as_tensor(np.round(g.standard_normal((3, 48000)) * 3000).astype(np.int16), device=dev)
    lengths = torch.tensor([48000, 20011, 0], dtype=torch.int32, device=dev)
    prefix, nv, mask = frontend.logmel_prefix_counts(audio, lengths, cfg)
    tail.tail_launches = tail.tail_split_launches = tail.tail_base_launches = 0
    got = tail.feature_tail(prefix, nv, cfg)
    torch.cuda.synchronize()
    assert (tail.tail_launches, tail.tail_split_launches, tail.tail_base_launches) == (1, 1 + cfg.deltas, 1)
    errs = testing.tail_errors(got, tail.feature_tail_reference(prefix, nv, cfg))
    assert not testing.tail_failures(errs), errs
    assert bool((got[mask == 0] == 0).all())
    assert torch.equal(_bits(got), _bits(tail.feature_tail(prefix, nv, cfg)))
    shifted = torch.empty(prefix.numel() + 1, device=dev)[1:].view(prefix.shape)
    shifted.copy_(prefix)
    assert torch.equal(_bits(got), _bits(tail.feature_tail(shifted, nv, cfg)))


GATHER_CASES = [
    ("classic13_deltas", {"hop_s": 0.2}),
    ("classic13_deltas", {"win_len_s": 3.0}),
    ("kaldi_mfcc", {"dither": 1.0, "hop_s": 0.25}),
    ("kaldi_mfcc", {"win_len_s": 1.6, "energy_source": "windowed_frame"}),
    ("whisper80", {"hop_s": 0.2}),
    ("logmel80", {"sample_rate": 22050, "n_fft": 8192, "win_len_s": 8192 / 22050,
                  "hop_s": 2048 / 22050, "n_mels": 128}),
    ("classic13", {"n_fft": 6001}),
]
GATHER_IDS = ["hop_0.2", "frames_3s", "kaldi_dither_hop_0.25", "kaldi_frames_1.6s_windowed",
              "whisper80_hop_0.2", "librosa_8192_hop_2048", "bluestein_6001_global"]


@pytest.mark.parametrize("name,overrides", GATHER_CASES, ids=GATHER_IDS)
def test_gather_plan_matches_reference(name, overrides):
    """The gather plan (each frame read from device memory) against the
    float64 plain version on the CPU at the prefix gates, int16 ≡ float32
    and two runs bitwise, its n_valid and mask bitwise the chain's,
    counted."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    assert frontend.fft_plan(cfg).startswith("gather")
    g = np.random.default_rng(len(overrides))
    n = cfg.sample_rate * 6
    lens = [n, n - 12345, 3 * cfg.frame_length // 2, 1]
    b = pad_batch([np.round(g.standard_normal(m) * 3000) for m in lens], cfg, bucket_len=n, dtype="int16")
    audio, lengths = torch.as_tensor(b.audio, device=dev), torch.as_tensor(b.lengths, device=dev)
    frontend.gather_launches = 0
    got, nv, mask = frontend.logmel_prefix_counts(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert frontend.gather_launches == 1
    want = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), cfg.replace(dtype="float64"))
    narrow = None
    if cfg.logmel_norm == "whisper":  # its narrow filters take the per-bin gate
        narrow = testing.narrow_lanes(chain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"])
    assert_prefix_close(got, want, cfg.n_mels, cfg.log_kind, cfg.features, narrow)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))
    wnv, wmask = frontend.frame_counts_reference(lengths, cfg, got.shape[1])
    assert torch.equal(nv, wnv) and torch.equal(mask, wmask)


# n_fft past the gather plan's layouts: (config, overrides, the plan without
# the cluster plan, which the ladder takes at CLUSTER_MIN_POINTS[form]
# points or more)
ANY_NFFT_CASES = [
    ("classic13", {"n_fft": 7001}, "gather_bands"),
    ("classic13_deltas", {"n_fft": 16384}, "gather_bands"),
    ("kaldi_mfcc", {"dither": 1.0, "n_fft": 16384, "win_len_s": 0.5}, "gather_bands"),
    ("whisper80", {"n_fft": 16384}, "gather_bands"),
    ("kaldi_plp", {"n_fft": 16384}, "gather_bands"),
    ("classic13", {"n_fft": 13001}, "gather_rows"),
    ("classic13_deltas", {"n_fft": 32768}, "gather_rows"),
    ("ssc26", {"n_fft": 32768}, "gather_rows"),
    ("kaldi_spectrogram", {"n_fft": 13001, "n_mels": 6501}, "gather_rows"),
    ("logmel80", {"sample_rate": 48000, "n_fft": 65536, "win_len_s": 65536 / 48000,
                  "hop_s": 16384 / 48000}, "gather_rows"),
    ("classic13", {"n_fft": 131072}, "gather_rows"),
]
ANY_NFFT_IDS = ["bands_7001", "bands_16384", "bands_kaldi_dither_16384", "bands_whisper80_16384",
                "bands_plp_16384", "rows_13001", "rows_32768", "rows_ssc_32768",
                "rows_spectrogram_13001", "rows_48k_65536", "rows_131072_bin_field"]


def _nan_workspace(monkeypatch):
    """The wrapper's "gather_rows" workspace filled with NaN (its contents
    must not matter)."""
    monkeypatch.setattr(frontend, "_workspace",
                        lambda n, device: torch.full((n,), float("nan"), device=device))


def _without_cluster(monkeypatch):
    """The layout mirror without the cluster plan: the parent's plans."""
    own = frontend.fft_layout
    monkeypatch.setattr(frontend, "fft_layout",
                        lambda cfg, form=None, int16=True, cluster=True: own(cfg, form, int16, False))


@pytest.mark.parametrize("name,overrides,plan", ANY_NFFT_CASES, ids=ANY_NFFT_IDS)
def test_any_n_fft_matches_reference(name, overrides, plan, monkeypatch):
    """The plans past the gather plan's layouts, each case in both: the
    cluster plan (each frame's FFT rows over a thread-block cluster's
    shared memory; the ladder's at CLUSTER_MIN_POINTS[form] points or more,
    else forced at the smallest cluster that fits), and forced without it
    "gather_bands"
    (the packed mel bands read from device memory) and "gather_rows" (the
    FFT rows in a workspace in device memory, the bin field past 16 bits at
    131,072): each against the float64 plain version on the CPU at the
    prefix gates, int16 ≡ float32, two runs, a persistent grid of 3
    clusters, and for the parent's plans a NaN-filled workspace and a
    persistent grid of 3 blocks (each looping over many tiles through its
    own slot), bitwise, n_valid and the mask bitwise the chain's in both,
    counted by plan."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    form = frontend.dft_form(cfg)
    assert frontend.fft_layout(cfg, cluster=False)[0] == plan
    big = frontend.fft_points(cfg.n_fft, form) >= frontend.CLUSTER_MIN_POINTS[form]
    assert frontend.fft_plan(cfg) == ("cluster" if big else plan)
    C = next(c for c in frontend.CLUSTER_SIZES
             if frontend.cluster_smem(cfg, form, c) <= rs_kernel.SMEM_BUDGET_BYTES)
    monkeypatch.setattr(frontend, "fft_layout", lambda *a, **k: ("cluster", C))
    assert chain.unsupported_reason(cfg) is None
    g = np.random.default_rng(cfg.n_fft + cfg.n_mels)
    n = max(cfg.sample_rate * 2, 2 * cfg.frame_length)
    lens = [n, n - 12345, 3 * cfg.frame_length // 2, 1]
    b = pad_batch([np.round(g.standard_normal(m) * 3000) for m in lens], cfg, bucket_len=n, dtype="int16")
    audio, lengths = torch.as_tensor(b.audio, device=dev), torch.as_tensor(b.lengths, device=dev)
    want = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), cfg.replace(dtype="float64"))
    narrow = None
    if cfg.logmel_norm == "whisper":  # its narrow filters take the per-bin gate
        narrow = testing.narrow_lanes(chain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"])
    frontend.cluster_launches = frontend.gather_launches = 0
    got, nv, mask = frontend.logmel_prefix_counts(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert (frontend.cluster_launches, frontend.gather_launches) == (1, 1)
    assert_prefix_close(got, want, cfg.n_mels, cfg.log_kind, cfg.features, narrow)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))
    monkeypatch.setattr(frontend, "_active_clusters", lambda *args: 3)
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))
    wnv, wmask = frontend.frame_counts_reference(lengths, cfg, got.shape[1])
    assert torch.equal(nv, wnv) and torch.equal(mask, wmask)
    monkeypatch.undo()
    _without_cluster(monkeypatch)
    frontend.gather_bands_launches = frontend.gather_rows_launches = frontend.gather_launches = 0
    got, nv, mask = frontend.logmel_prefix_counts(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert frontend.gather_launches == 1
    assert (frontend.gather_bands_launches, frontend.gather_rows_launches) == (
        int(plan == "gather_bands"), int(plan == "gather_rows"))
    assert_prefix_close(got, want, cfg.n_mels, cfg.log_kind, cfg.features, narrow)
    assert torch.equal(nv, wnv) and torch.equal(mask, wmask)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    _nan_workspace(monkeypatch)
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))
    monkeypatch.setattr(frontend, "_resident_blocks", lambda *args: 3)
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))


# tens of thousands of filters: (config, overrides, plan of the default
# route without the wide plan, which takes each)
MANY_FILTER_CASES = [
    ("classic13_deltas", {"n_mels": 40000}, "gather_bands"),
    ("classic13", {"n_mels": 60000}, "gather_sums"),
    ("kaldi_plp", {"n_mels": 60000}, "gather_sums"),
    ("logmel80", {"n_mels": 33000}, "gather_bands"),
    ("ssc26", {"n_mels": 30000, "n_fft": 4096}, "gather_sums"),
]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name,overrides,plan", MANY_FILTER_CASES,
                         ids=["40000", "60000_sums", "plp_60000_sums", "logmel80_33000", "ssc_30000_sums"])
def test_many_filters_match_reference(name, overrides, plan, monkeypatch):
    """Tens of thousands of filters (refused before: over the packed table's
    filter field; from 57,849, 28,797 for SSC, the projection's sums over
    the block, "gather_sums"), in the wide plan (the projection filter by
    filter over a tile of frames): the kernel against the float64 plain
    version on the CPU at the prefix gates (filters of at most two weights
    at the per-bin gate; NaN, an SSC filter with no weight, in the plain
    version's places), int16 ≡ float32, a NaN-filled workspace and a
    persistent grid of 3 blocks (which it does not use), bitwise; counted by
    plan; the plan it replaced, forced, within the same gates, int16 ≡
    float32, a NaN-filled workspace and a persistent grid of 3 blocks
    bitwise ("gather_sums" keeps its SSC melf sums in that workspace), and
    where every filter has one weight and its FFT stage runs the same
    groups, bitwise the wide plan's; the bf16x3 opt-in at the same config in
    "gather_out" against its plain version at its gates."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    assert frontend.fft_plan(cfg) == "wide" and chain.unsupported_reason(cfg) is None
    assert frontend.fft_layout(cfg, wide=False)[0] == plan
    g = np.random.default_rng(cfg.n_mels)
    n = cfg.sample_rate
    lens = [n, n - 2345, 3 * cfg.frame_length // 2, 1]
    b = pad_batch([np.round(g.standard_normal(m) * 3000) for m in lens], cfg, bucket_len=n, dtype="int16")
    audio, lengths = torch.as_tensor(b.audio, device=dev), torch.as_tensor(b.lengths, device=dev)
    frontend.gather_bands_launches = frontend.gather_sums_launches = frontend.wide_launches = 0
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert (frontend.gather_bands_launches, frontend.gather_sums_launches, frontend.wide_launches) == (0, 0, 1)
    narrow = None  # the fp32 route's filters of at most two weights: the per-bin gate
    if cfg.features != "ssc":
        narrow = testing.narrow_lanes(chain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"])
    want64 = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), cfg.replace(dtype="float64"))
    own = frontend.fft_layout
    with monkeypatch.context() as mp:
        # the plan the wide plan replaced, forced: at the gates, int16 ≡
        # float32, and a NaN-filled workspace and a persistent grid of 3
        # blocks ("gather_sums" reads its workspace), bitwise
        mp.setattr(frontend, "fft_layout", lambda cfg, form=None, int16=True, cluster=True, wide=True:
                   own(cfg, form, int16, cluster, False))
        parent = frontend.logmel_prefix(audio, lengths, cfg)
        torch.cuda.synchronize()
        assert (frontend.gather_bands_launches, frontend.gather_sums_launches) == (
            int(plan == "gather_bands"), int(plan == "gather_sums"))
        same_groups = frontend.wide_layout(cfg)[0] == own(cfg, wide=False)[1]
        nan = torch.isnan(want64)
        parent_c = parent.cpu()
        assert torch.equal(torch.isnan(parent_c), nan)
        errs = testing.prefix_errors(parent_c.masked_fill(nan, 0.0), want64.masked_fill(nan, 0.0), cfg.n_mels,
                                     cfg.log_kind, cfg.features, narrow)
        assert not testing.prefix_failures(errs), (plan, errs)
        assert torch.equal(_bits(parent), _bits(frontend.logmel_prefix(audio.float(), lengths, cfg)))
        _nan_workspace(mp)
        assert torch.equal(_bits(parent), _bits(frontend.logmel_prefix(audio, lengths, cfg)))
        mp.setattr(frontend, "_resident_blocks", lambda *args: 3)
        assert torch.equal(_bits(parent), _bits(frontend.logmel_prefix(audio, lengths, cfg)))
    if frontend.packed_count(cfg) == cfg.n_mels and same_groups:
        assert torch.equal(_bits(got), _bits(parent))
    else:
        assert torch.equal(_bits(got[..., :-1]), _bits(parent[..., :-1]))  # the energy lane's group sums differ
    for passes, want, loud in (
            ("radix4", want64, None),
            ("bf16x3", None, testing.BF16X3_LOUD_ATOL)):
        if passes == "bf16x3":
            frontend.bf16_gather_out_launches = 0
            got = frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")
            torch.cuda.synchronize()
            assert frontend.bf16_gather_out_launches == 1
            want = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3").cpu()
        got_c = got.cpu()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got_c), nan)
        errs = testing.prefix_errors(got_c.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0), cfg.n_mels,
                                     cfg.log_kind, cfg.features, narrow if loud is None else None)
        assert not testing.prefix_failures(errs, loud), (passes, errs)
        assert torch.equal(_bits(got), _bits(frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes=passes)))
    got = frontend.logmel_prefix(audio, lengths, cfg)
    _nan_workspace(monkeypatch)
    assert torch.equal(_bits(got), _bits(frontend.logmel_prefix(audio, lengths, cfg)))
    monkeypatch.setattr(frontend, "_resident_blocks", lambda *args: 3)
    assert torch.equal(_bits(got), _bits(frontend.logmel_prefix(audio, lengths, cfg)))


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("name,overrides", [("classic13_deltas", {"n_fft": 16384}),
                                            ("kaldi_mfcc", {"dither": 1.0, "n_fft": 12502})],
                         ids=["stockham_16384", "bluestein_kaldi_dither_12502"])
def test_cluster_sizes_match_reference(name, overrides, C, monkeypatch):
    """The cluster plan forced at 2, 4 and 8 blocks a frame (the Stockham
    form, and the Bluestein form with dither and conditioning) against the
    float64 plain version at the prefix gates, int16 ≡ float32 and two runs
    bitwise, counted; no local memory."""
    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**overrides)
    monkeypatch.setattr(frontend, "fft_layout", lambda *a, **k: ("cluster", C))
    info = frontend.kernel_info(cfg)
    assert info["local_bytes"] == 0 and info["clusters"] >= 1, info
    g = np.random.default_rng(C)
    n = 2 * cfg.sample_rate
    b = pad_batch([np.round(g.standard_normal(m) * 3000) for m in (n, n - 777, 500)], cfg, bucket_len=n,
                  dtype="int16")
    audio, lengths = torch.as_tensor(b.audio, device=dev), torch.as_tensor(b.lengths, device=dev)
    frontend.cluster_launches = 0
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    assert frontend.cluster_launches == 1
    want = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), cfg.replace(dtype="float64"))
    assert_prefix_close(got, want, cfg.n_mels, cfg.log_kind, cfg.features)
    assert torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))


@pytest.mark.parametrize("n_fft,plan", [(16384, "gather_bands"), (32768, "gather_rows")])
def test_any_n_fft_block_launch_matches_offline(n_fft, plan, monkeypatch):
    """The block launch (streaming's, row origin 1) in the cluster plan (the
    ladder's at both sizes), and without it in the parent's
    plan on a NaN-filled workspace, ≡ the offline prefix of the same plan
    on its valid frames, bitwise."""
    dev = _card()
    cfg = NAMED_CONFIGS["classic13_deltas"].replace(n_fft=n_fft)
    assert frontend.fft_layout(cfg, cluster=False)[0] == plan
    assert frontend.fft_plan(cfg) == "cluster"
    monkeypatch.setattr(frontend, "fft_layout", lambda *a, **k: ("cluster", 2))
    g = np.random.default_rng(n_fft)
    audio = torch.as_tensor(np.round(g.standard_normal((1, 48000)) * 3000).astype(np.int16), device=dev)
    lengths = torch.tensor([47000], dtype=torch.int32, device=dev)
    K, S, L, f0 = 16, cfg.frame_step, cfg.frame_length, 7
    span = (K - 1) * S + L
    rows = audio[:, f0 * S - 1 : f0 * S + span].float().contiguous()
    valid = torch.tensor([span], dtype=torch.int32, device=dev)
    for parent in (False, True):
        if parent:
            monkeypatch.undo()
            _without_cluster(monkeypatch)
            _nan_workspace(monkeypatch)
        offline = frontend.logmel_prefix(audio, lengths, cfg)
        blk = frontend.logmel_block(rows, valid, cfg)
        torch.cuda.synchronize()
        assert torch.equal(blk, offline[:, f0 : f0 + K]), parent


def test_extract_batch_keeps_the_callers_tf32_flag():
    """A caller's TF32 setting survives extract_batch (the port's matmuls run
    in float64 on the card and read or write no global flag), and kaldi_plp's
    features, whose PLP IDFT is a torch matmul, stay within the family gate
    of the CPU chain."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sigs = golden_signals()
        for name in ("classic13_deltas", "kaldi_plp"):
            cfg = NAMED_CONFIGS[name]
            b = pad_batch([np.round(sigs[n] * 3000) for n in ("noise", "speechish", "short")], cfg,
                          dtype="int16")
            feat, _ = chain.extract_batch(b.audio, b.lengths, cfg)
            torch.cuda.synchronize()
            assert torch.backends.cuda.matmul.allow_tf32 is True
        cpu, _ = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
        valid = torch.as_tensor(b.lengths) >= cfg.frame_length
        testing.assert_family_features_close(feat.cpu()[valid], cpu[valid], cfg.features)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_the_tf32_flag_survives_concurrent_calls():
    """Four threads run extract_batch for kaldi_plp and ssc26 (their
    epilogues hold torch matmuls: the PLP IDFT; the SSC centroids on the plain
    stages) while the caller's TF32 flag is True: it reads True in every
    thread after every call and after all of them, and each thread's features
    stay within the family gate of the CPU chain."""
    from concurrent.futures import ThreadPoolExecutor

    dev = _card()
    sigs = golden_signals()
    jobs = []
    for name in ("kaldi_plp", "ssc26"):
        cfg = NAMED_CONFIGS[name]
        b = pad_batch([np.round(sigs[n] * 3000) for n in ("noise", "speechish", "short")], cfg,
                      dtype="int16")
        cpu, _ = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
        jobs.append((cfg, b, cpu))

    def run(job):
        cfg, b, _ = job
        flags = []
        for _ in range(5):
            if cfg.features == "ssc":
                audio = torch.as_tensor(b.audio, device=dev)
                lengths = torch.as_tensor(b.lengths, device=dev)
                feat = chain.features_from_logmel(chain.logmel_stages(audio, lengths, cfg), cfg)
            else:
                feat, _ = chain.extract_batch(b.audio, b.lengths, cfg)
            torch.cuda.synchronize()
            flags.append(torch.backends.cuda.matmul.allow_tf32)
        return feat.cpu(), flags

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with ThreadPoolExecutor(4) as pool:
            results = list(pool.map(run, jobs * 2))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for (cfg, b, cpu), (feat, flags) in zip(jobs * 2, results):
        assert all(f is True for f in flags), flags
        valid = torch.as_tensor(b.lengths) >= cfg.frame_length
        testing.assert_family_features_close(feat[valid], cpu[valid], cfg.features)


# ---------------------------------------------------------------------------
# the plain chain at n_fft 551; the corpus path (CLI, long files, the feed)
# ---------------------------------------------------------------------------


def _pcm_rows(lengths, seed):
    g = np.random.default_rng(seed)
    return [(g.standard_normal(n) * 3000).astype(np.int16) for n in lengths]


def test_plain_chain_at_n_fft_551_matches_the_cpu_chain():
    """The plain chain on the card at n_fft 551 (= 19·29): cuFFT's rfft gave
    11 frames of this b16 x 10 s batch wrong by up to 1.7e-2 of their
    largest bin (log-mel off by 22.69); `chain.power_spectrum` takes the DFT
    as a float64 product there. Held to the CPU chain at the log-mel gate,
    batched and through `logmel_single`."""
    dev = _card()
    cfg = NAMED_CONFIGS["classic13"].replace(n_fft=551)
    n16 = 160000
    lengths = [n16 - 571 * i for i in range(16)]
    b = pad_batch(_pcm_rows(lengths, 30), cfg, bucket_len=n16, dtype="int16")
    audio, lens = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)
    got = chain.logmel_stages(audio.to(dev), lens.to(dev), cfg)
    want = chain.logmel_stages(audio, lens, cfg)
    for i, n in enumerate(lengths):
        f = cfg.num_frames(n)
        testing.assert_logmel_close(got["logmel"][i, :f].cpu(), want["logmel"][i, :f])
    for i in (0, 3, 15):
        x = audio[i, : lengths[i]]
        testing.assert_logmel_close(chain.logmel_single(x, cfg, device="cuda")["logmel"].cpu(),
                                    chain.logmel_single(x, cfg, device="cpu")["logmel"])


def _corpus(root, files, sr=16000, seed=0):
    from mfcc_tpu_torch.io import write_wav

    g = np.random.default_rng(seed)
    for i, n in enumerate(files):
        sub = root / f"spk{i % 3}"
        sub.mkdir(parents=True, exist_ok=True)
        env = np.repeat(g.uniform(0.05, 1.0, n // 800 + 1), 800)[:n]
        write_wav(sub / f"u{i:03d}.wav", sr, (g.standard_normal(n) * 6000 * env).astype(np.int16))
    return root


def _shards_close(a_dir, b_dir, cfg):
    from mfcc_tpu_torch.io import read_shard

    names = sorted(p.name for p in a_dir.glob("h*.npz"))
    assert names and names == sorted(p.name for p in b_dir.glob("h*.npz"))
    for name in names:
        a, b = read_shard(a_dir / name), read_shard(b_dir / name)
        assert list(a) == list(b)
        for k in a:
            if chain.resamples(cfg):
                np.testing.assert_allclose(a[k], b[k], atol=testing.RESAMPLED_FEATURE_ATOL,
                                           rtol=testing.RESAMPLED_FEATURE_RTOL)
            else:
                assert_features_close(a[k], b[k])
    return names


def test_cli_extract_on_the_card_matches_the_cpu_run(tmp_path):
    from mfcc_tpu_torch.cli import main

    _card()
    corpus = _corpus(tmp_path / "c", [8000, 23000, 5000, 41000, 16000, 2000, 15000, 9000, 12000])
    common = ["extract", str(corpus), "--config", "classic13_deltas", "--batch-size", "4",
              "--max-len-s", "1.0", "--feed", "direct"]
    before = (frontend.launches, tail.tail_launches)
    assert main([*common, "-o", str(tmp_path / "gpu")]) == 0
    launched = (frontend.launches - before[0], tail.tail_launches - before[1])
    assert main([*common, "-o", str(tmp_path / "cpu"), "--device", "cpu"]) == 0
    names = _shards_close(tmp_path / "gpu", tmp_path / "cpu", NAMED_CONFIGS["classic13_deltas"])
    batches = sum(not n.startswith("h0-long") for n in names)
    # a batch launches the front-end and the tail once; a long file (23,000
    # and 41,000 samples at 1 s segments) one front-end launch a group of
    # 8 segments and one tail launch
    assert launched == (batches + 2, batches + 2)


def test_long_48k_file_launches_the_resampler_once(tmp_path):
    from mfcc_tpu_torch.pipeline import extract_long

    dev = _card()
    cfg = NAMED_CONFIGS["mfcc39_48k"]
    g = np.random.default_rng(7)
    x = (g.standard_normal(48000 * 20) * 3000).astype(np.float32)
    before = rs_kernel.launches
    got = extract_long(x, cfg, device=dev, seg_len_s=1.0)
    torch.cuda.synchronize()
    assert rs_kernel.launches == before + 1
    want = chain.extract_single(torch.as_tensor(x), cfg, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=testing.RESAMPLED_FEATURE_ATOL,
                               rtol=testing.RESAMPLED_FEATURE_RTOL)


def test_pinned_rows_are_not_refilled_under_their_copy(tmp_path, monkeypatch):
    """The feed's pinned rows at pipeline depth 3 and a pool of 2 buffers: a
    batch is released right after its copy is enqueued, and the pool waits
    on the copy's event before refilling it, so the shards equal the CPU
    run's."""
    import importlib

    from mfcc_tpu_torch.pipeline import RowPool

    # the module (the package's `main` attribute is the function)
    cli_mod = importlib.import_module("mfcc_tpu_torch.cli.main")

    _card()
    pool = RowPool(pin=True)
    buf = pool.take(4, 1000, np.int16)
    assert torch.from_numpy(buf).is_pinned()
    monkeypatch.setattr(cli_mod, "FEED_BUFFERS", 2)
    g = np.random.default_rng(3)
    corpus = _corpus(tmp_path / "c", list(g.integers(3000, 16000, 60)), seed=3)
    common = ["extract", str(corpus), "--config", "classic13_deltas", "--batch-size", "4",
              "--pipeline-depth", "3", "--feed", "direct", "--max-len-s", "1.0"]
    assert cli_mod.main([*common, "-o", str(tmp_path / "gpu")]) == 0
    assert cli_mod.main([*common, "-o", str(tmp_path / "cpu"), "--device", "cpu"]) == 0
    assert len(_shards_close(tmp_path / "gpu", tmp_path / "cpu", NAMED_CONFIGS["classic13_deltas"])) >= 15


@pytest.mark.parametrize("name", ["classic13_deltas", "logmel80", "kaldi_mfcc", "kaldi_plp",
                                  "kaldi_spectrogram", "ssc26", "mfcc39_48k"])
def test_block_launch_matches_reference(name):
    """The front-end's block launch (streaming; rows whose sample 0 is the
    pre-context, frames from sample 1) ≡ its plain version at the prefix
    gates, with a zero and a dirty pre-context and valid at 0, 1, L - 1, L,
    L + 1 and span; samples past valid leave it unchanged, bitwise; one
    launch, counted. mfcc39_48k launches at its 16 kHz feature rate."""
    dev = _card()
    cfg = NAMED_CONFIGS[name]
    K, S, L = 16, cfg.frame_step, cfg.frame_length
    span = (K - 1) * S + L
    edges = [0, 1, L - 1, L, L + 1, span]
    g = np.random.default_rng(5)
    rows = torch.as_tensor((g.standard_normal((12, span + 1)) * 3000).astype(np.float32), device=dev)
    rows[:6, 0] = 0.0
    valid = torch.tensor(edges * 2, dtype=torch.int32, device=dev)
    before = frontend.block_launches
    got = frontend.logmel_block(rows, valid, cfg)
    torch.cuda.synchronize()
    assert frontend.block_launches == before + 1 and got.shape == (12, K, cfg.n_mels + 1)
    assert_prefix_close(got, frontend.logmel_block_reference(rows, valid, cfg), cfg.n_mels,
                        cfg.log_kind, cfg.features)
    t = torch.arange(span + 1, device=dev)[None, :]
    assert torch.equal(got, frontend.logmel_block(torch.where(t <= valid[:, None], rows, 0), valid, cfg))


@pytest.mark.parametrize("name, K", [("classic13_deltas", 16), ("classic13_deltas", 3),
                                     ("classic13", 8), ("kaldi_mfcc", 16)])
def test_pool_streams_are_bitwise_their_single_streams(name, K):
    """Each stream of a MultiStreamExtractor on the card, its sessions opened
    on turns 0..4 (staggered arrivals), is bitwise its own StreamingExtractor
    run, and within 5e-4 of the offline extract_batch; for classic13_deltas
    some round finalizes first and inner windows (two tail launches)."""
    from mfcc_tpu_torch.pipeline import MultiStreamExtractor, StreamingExtractor

    _card()
    cfg = NAMED_CONFIGS[name]
    g = np.random.default_rng(K)
    xs = [(g.standard_normal(int(n)) * 3000).astype(np.float32) for n in (16373, 7001, 399, 31999, 0)]
    pool = MultiStreamExtractor(cfg, 5, frames_per_block=K)
    inner, fins = pool._engine.round, []

    def round_(entries):
        res = inner(entries)
        fins.append(res.fin_launches)
        return res

    pool._engine.round = round_
    sids, got, pos, turn = [None] * len(xs), {}, [0] * len(xs), 0
    while turn < len(xs) or pool.n_active:
        for i, x in enumerate(xs):
            if i == turn:
                sids[i] = pool.open()
                got[sids[i]] = []
            if i > turn or pool.done(sids[i]) or pos[i] > len(x):
                continue
            if pos[i] < len(x):
                pool.push(sids[i], x[pos[i] : pos[i] + 2560])
            if pos[i] + 2560 >= len(x):
                pool.end(sids[i])
            pos[i] += 2560
        turn += 1
        for s, f in pool.poll().items():
            got[s].append(f)
    if name == "classic13_deltas":
        assert max(fins) == 2
    assert max(fins) <= 2
    for s, x in zip(sids, xs):
        mine = np.concatenate(got[s])
        ex = StreamingExtractor(cfg, frames_per_block=K)
        want = np.concatenate([ex.push(x), ex.flush()])
        assert np.array_equal(mine, want)
        if len(x):
            off = chain.extract_single(torch.as_tensor(x), cfg).cpu().numpy()
            assert mine.shape == off.shape
            np.testing.assert_allclose(mine, off, atol=testing.FEATURE_ATOL, rtol=testing.FEATURE_RTOL)


def test_streaming_without_a_card_raises():
    """With no card visible, StreamingExtractor() and MultiStreamExtractor()
    (device "cuda" by default) raise instead of running on the CPU."""
    import os
    import subprocess
    import sys

    _card()
    code = (
        "from mfcc_tpu_torch import named_config\n"
        "from mfcc_tpu_torch.pipeline import MultiStreamExtractor, StreamingExtractor\n"
        "cfg = named_config('classic13_deltas')\n"
        "for make in (lambda: StreamingExtractor(cfg), lambda: MultiStreamExtractor(cfg, 2)):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n"
        "print('raised')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": repo}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert res.returncode == 0 and res.stdout.strip() == "raised", res.stderr


_DIFF_CASES = [(name, {}) for name in ("classic13_deltas", "logmel80", "kaldi_mfcc", "kaldi_plp",
                                        "kaldi_spectrogram", "ssc26", "whisper80", "mfcc39_48k")]


@pytest.mark.parametrize("name, over", [*_DIFF_CASES, ("kaldi_mfcc", {"dither": 1.0})],
                         ids=[name for name, _ in _DIFF_CASES] + ["kaldi_mfcc_dither"])
def test_extract_batch_diff_on_the_card(name, over):
    """The training path at b4: the forward bitwise extract_batch's (the
    kernels; with dither the kernel's dither branch, once), the gradient of
    (feat**2).sum() within 1e-3 (relative max diff, the reference's gate)
    of the float64 plain chain's on the card (with the same contract
    noise), a row-0 loss giving exactly zero gradient on row 1 and past
    row 0's length."""
    from mfcc_tpu_torch.kernels import frontend

    dev = _card()
    cfg = NAMED_CONFIGS[name].replace(**over)
    sr = cfg.input_sample_rate or cfg.sample_rate
    g = np.random.default_rng(31)
    b = pad_batch([g.standard_normal(sr - 571 * i * sr // 16000) * 3000 for i in range(4)], cfg)
    lengths = torch.as_tensor(b.lengths, device=dev)
    a = torch.tensor(b.audio, dtype=torch.float32, device=dev, requires_grad=True)
    dithered = frontend.dither_launches
    feat, mask = chain.extract_batch_diff(a, lengths, cfg)
    assert frontend.dither_launches - dithered == (cfg.dither > 0)
    want, want_mask = chain.extract_batch(a.detach(), lengths, cfg)
    assert torch.equal(feat, want) and torch.equal(mask, want_mask) and not mask.requires_grad
    (feat**2).sum().backward()
    a64 = a.detach().double().requires_grad_(True)
    f64, _ = chain.plain_chain(a64, lengths, cfg.replace(dtype="float64"))
    (f64**2).sum().backward()
    assert torch.isfinite(a.grad).all()
    rel = float((a.grad.double() - a64.grad).abs().max() / a64.grad.abs().max())
    assert rel < 1e-3, rel
    a.grad = None
    feat, _ = chain.extract_batch_diff(a, lengths, cfg)
    (feat[0] ** 2).sum().backward()
    assert not a.grad[1:].any() and not a.grad[0, b.lengths[0]:].any() and a.grad[0].any()


def test_cli_feed_mp_writes_the_direct_feeds_shards_on_the_card(tmp_path):
    """`extract --feed mp` on the card (pinned slabs) writes the shards of
    `--feed direct` (pinned rows): the npz members' bytes equal, the zip
    timestamps aside; no slab file is left in the pool's directory."""
    import glob
    import importlib
    import os
    import zipfile

    from mfcc_tpu_torch.io import reader

    cli_mod = importlib.import_module("mfcc_tpu_torch.cli.main")
    _card()
    g = np.random.default_rng(9)
    corpus = _corpus(tmp_path / "c", list(g.integers(3000, 40000, 40)), seed=9)
    common = ["extract", str(corpus), "--config", "classic13_deltas", "--batch-size", "4",
              "--pipeline-depth", "3", "--max-len-s", "2.0"]
    assert cli_mod.main([*common, "-o", str(tmp_path / "mp"), "--feed", "mp"]) == 0
    assert cli_mod.main([*common, "-o", str(tmp_path / "direct"), "--feed", "direct"]) == 0
    names = sorted(p.name for p in (tmp_path / "direct").glob("h0-*.npz"))
    assert len(names) >= 10 and names == sorted(p.name for p in (tmp_path / "mp").glob("h0-*.npz"))
    for name in names:
        with zipfile.ZipFile(tmp_path / "mp" / name) as a, zipfile.ZipFile(tmp_path / "direct" / name) as b:
            assert {n: a.read(n) for n in a.namelist()} == {n: b.read(n) for n in b.namelist()}
    assert not glob.glob(f"{reader._shm_dir()}/mfcc_tpu_torch_slab_{os.getpid()}_*")


def test_info_self_test_passes_on_the_card(capsys):
    from mfcc_tpu_torch.cli import main

    _card()
    assert main(["info", "--self-test"]) == 0
    out = capsys.readouterr().out
    assert "self-test: PASS" in out and out.count(" cuda  max|err|=") == 2
