"""The port's chain, batching and entry points ≡ the JAX package's.

The same numpy inputs go through both packages:
  - port `extract_batch(device="cpu")` on int16 rows vs JAX
    `extract_batch(backend="pallas")` on the int16 slab feed (as bench.py
    drives it): the port's F frames agree within the lifted-cepstra gate
    (atol 5e-4, rtol 1e-5, `mfcc_tpu_torch.testing`) and the JAX frames
    past F (slab capacity) are zero;
  - the frozen float64 goldens and the float64 oracle (1e-10 in float64);
  - the jnp chain, masking invariance and the host batching helpers.
A subprocess proves the port loads no jax and no mfcc_tpu module.
"""

import concurrent.futures
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mfcc_tpu
import mfcc_tpu_torch
from mfcc_tpu import pipeline as jpipeline
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.ops import constants as jconstants
from mfcc_tpu.ops import reference_numpy
from mfcc_tpu.testing.golden import golden_signals, load_golden
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.ops import constants as tconstants
from mfcc_tpu_torch.pipeline import batch as tbatch
from mfcc_tpu_torch.testing import (
    RESAMPLED_FEATURE_ATOL, RESAMPLED_FEATURE_RTOL, assert_family_features_close, assert_features_close,
)
from tests.test_jnp_chain import assert_logmel_close

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ["classic13", "classic13_deltas"]
SIGNALS = ("noise", "speechish", "short", "tone_offbin")
# centered framing of resampled rows, once outside the port: whisper80 fed
# 48 kHz, the families centered at 48 kHz (the split route on the card,
# `frontend.resample_route`; resample_input then logmel_stages here)
OUTSIDE = {"whisper80": {"input_sample_rate": 48000}}
OUTSIDE.update({name: {"frame_tail": "center", "input_sample_rate": 48000}
                for name in ("kaldi_plp", "kaldi_spectrogram", "ssc26")})
OUTSIDE_PALLAS = ("whisper80", "ssc26")  # also held to the Pallas route (interpret mode)


def _pcm(names=SIGNALS, scale=3000.0):
    sigs = golden_signals()
    return [np.round(sigs[n] * scale) for n in names]


@pytest.mark.parametrize("config_name", CONFIGS)
def test_extract_batch_matches_pallas_on_int16_slab_feed(config_name):
    jcfg, tcfg = J_CONFIGS[config_name], T_CONFIGS[config_name]
    utts = _pcm()
    blen = max(u.shape[0] for u in utts)
    jb = jpipeline.pad_batch(
        utts, jcfg, bucket_len=blen, layout=jpipeline.device_layout(jcfg, blen)
    )
    jfeat, jmask = jchain.extract_batch(
        jnp.asarray(jb.audio.astype(np.int16)), jnp.asarray(jb.lengths), jcfg,
        backend="pallas",
    )
    jfeat, jmask = np.asarray(jfeat), np.asarray(jmask)
    tb = tbatch.pad_batch(utts, tcfg, bucket_len=blen, dtype="int16")
    feat, mask = tchain.extract_batch(tb.audio, tb.lengths, tcfg, device="cpu")
    F = tcfg.num_frames(tb.audio.shape[1])
    assert feat.shape == (len(utts), F, tcfg.feat_dim) and feat.dtype == torch.float32
    assert jfeat.shape[1] > F  # the slab feed returns capacity frames
    assert_features_close(feat.numpy(), jfeat[:, :F])
    np.testing.assert_array_equal(jfeat[:, F:], 0.0)
    np.testing.assert_array_equal(mask.numpy(), jmask[:, :F])


@pytest.mark.parametrize("config_name", CONFIGS)
@pytest.mark.parametrize("signal_name", sorted(golden_signals()))
def test_golden_parity(config_name, signal_name):
    g = load_golden(config_name, signal_name)
    feat = mfcc_tpu_torch.extract(g["signal"], T_CONFIGS[config_name], device="cpu")
    assert_features_close(feat.numpy(), g["features"])


@pytest.mark.parametrize("config_name", CONFIGS)
def test_float64_exact_vs_oracle(config_name):
    """In float64 the port matches the float64 oracle to ~1e-10: every
    convention is exact and the fp32 residual is pure roundoff."""
    cfg = T_CONFIGS[config_name].replace(dtype="float64")
    sigs = golden_signals()
    for name in ("chirp", "noise", "speechish"):
        want = reference_numpy.extract_stages(sigs[name], J_CONFIGS[config_name])
        feat = mfcc_tpu_torch.extract(sigs[name], cfg, device="cpu")
        assert feat.dtype == torch.float64
        np.testing.assert_allclose(feat.numpy(), want["features"], atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("config_name", CONFIGS)
def test_masking_invariance(config_name):
    """An utterance inside a padded batch gives the same bytes on its valid
    frames as alone at the same T, and exact zeros on pad frames."""
    cfg = T_CONFIGS[config_name]
    utts = _pcm(("noise", "short", "speechish", "tone_offbin"))
    b = tbatch.pad_batch(utts, cfg, dtype="int16")
    feat, mask = tchain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    for i, u in enumerate(utts):
        fv = cfg.num_frames(u.shape[0])
        alone = np.zeros((1, b.audio.shape[1]), np.int16)
        alone[0, : u.shape[0]] = u
        feat_s, _ = tchain.extract_batch(alone, [u.shape[0]], cfg, device="cpu")
        np.testing.assert_array_equal(feat[i, :fv].numpy(), feat_s[0, :fv].numpy())
        assert bool(mask[i, :fv].all()) and not bool(mask[i, fv:].any())
        np.testing.assert_array_equal(feat[i, fv:].numpy(), 0.0)


@pytest.mark.parametrize("config_name", ["classic13", "classic13_deltas", "ssc26"])
def test_masking_invariance_with_four_torch_threads(config_name):
    """The masking invariance (bitwise) with four torch threads, set here
    and restored after, so a host that runs one thread cannot hide a
    float32 product whose result depends on the batch's shape (the CPU
    chain's mel, DCT and SSC products, `chain.matmul_fp32`)."""
    from tests import test_torch_families

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        if config_name in CONFIGS:
            test_masking_invariance(config_name)
        else:
            test_torch_families.test_masking_invariance(config_name)
    finally:
        torch.set_num_threads(threads)


def _jnp_batch(tcfg, jcfg, names=SIGNALS):
    b = tbatch.pad_batch(_pcm(names), tcfg)
    jf, jm = jchain.extract_batch(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg)
    return b, np.asarray(jf), np.asarray(jm)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"deltas": 2}, {"energy_floor": 1e4},
     {"append_energy": False, "lifter": 0}],
    ids=["classic13", "deltas", "energy_floor", "no_energy"],
)
def test_matches_jnp_chain(overrides):
    tcfg = T_CONFIGS["classic13"].replace(**overrides)
    b, jfeat, jmask = _jnp_batch(tcfg, J_CONFIGS["classic13"].replace(**overrides))
    feat, mask = tchain.extract_batch(b.audio, b.lengths, tcfg, device="cpu")
    assert_features_close(feat.numpy(), jfeat)
    np.testing.assert_array_equal(mask.numpy(), jmask)


def test_cmvn_utterance_matches_jnp():
    """Per-utterance CMVN: mean 0 / variance 1 over valid frames only, and
    the jnp chain's numbers. (The pure tone is left out: some of its
    cepstra have near-zero variance, and dividing by it amplifies fp32
    roundoff past any fixed gate in both packages.)"""
    over = {"cmvn": "utterance", "deltas": 2}
    tcfg = T_CONFIGS["classic13"].replace(**over)
    names = ("noise", "speechish", "short")
    b, jfeat, _ = _jnp_batch(tcfg, J_CONFIGS["classic13"].replace(**over), names)
    feat, mask = tchain.extract_batch(b.audio, b.lengths, tcfg, device="cpu")
    assert_features_close(feat.numpy(), jfeat)
    for i in range(2):  # "short" has one frame: zero variance
        valid = feat[i][mask[i] > 0].double().numpy()
        np.testing.assert_allclose(valid.mean(axis=0), 0.0, atol=1e-4)
        np.testing.assert_allclose(valid.var(axis=0), 1.0, atol=1e-2)


def test_logmel_features_match_jnp():
    over = {"features": "logmel", "deltas": 1}
    tcfg = T_CONFIGS["classic13"].replace(**over)
    b, jfeat, _ = _jnp_batch(tcfg, J_CONFIGS["classic13"].replace(**over))
    feat, _ = tchain.extract_batch(b.audio, b.lengths, tcfg, device="cpu")
    M = tcfg.n_mels
    valid = b.lengths > 0
    assert_logmel_close(feat.numpy()[valid, :, :M], jfeat[valid, :, :M], tcfg)
    np.testing.assert_allclose(feat.numpy()[..., M:], jfeat[..., M:], atol=1e-4)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"deltas": 2}, {"cmvn": "utterance"}, {"energy_floor": 1e4},
     {"features": "logmel"}],
    ids=["classic13", "deltas", "utt_cmvn", "energy_floor", "logmel"],
)
def test_prefix_path_equals_stage_path(overrides):
    """features_from_logmel's prefix path (the kernel's [log-mel | energy]
    output, one augmented DCT matmul) ≡ its stage path."""
    cfg = T_CONFIGS["classic13"].replace(**overrides)
    b = tbatch.pad_batch(_pcm(), cfg, dtype="int16")
    audio, lengths = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)
    stages = tchain.logmel_stages(audio, lengths, cfg)
    prefix = frontend.logmel_prefix(audio, lengths, cfg)
    via_prefix = tchain.features_from_logmel(
        {"prefix": prefix, "n_valid": stages["n_valid"],
         "frame_mask": stages["frame_mask"]}, cfg,
    )
    assert_features_close(via_prefix.numpy(), tchain.features_from_logmel(stages, cfg).numpy())


def test_gcmvn_features_come_back_unnormalized():
    b = tbatch.pad_batch(_pcm(), T_CONFIGS["classic13_deltas"], dtype="int16")
    plain, _ = tchain.extract_batch(b.audio, b.lengths, T_CONFIGS["classic13_deltas"], device="cpu")
    g, _ = tchain.extract_batch(b.audio, b.lengths, T_CONFIGS["classic13_deltas_gcmvn"], device="cpu")
    assert torch.equal(plain, g)


def test_carry_over_of_jax_constants():
    """The JAX package's numpy constants, carried over with to_torch, give
    the port the same features as its own copy of them."""
    cfg = T_CONFIGS["classic13_deltas"]
    host = jconstants.chain_constants(J_CONFIGS["classic13_deltas"])
    consts = tconstants.to_torch(host, "cpu", torch.float32)
    b = tbatch.pad_batch(_pcm(), cfg, dtype="int16")
    own, _ = tchain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    carried, _ = tchain.extract_batch(b.audio, b.lengths, cfg, device="cpu", consts=consts)
    assert torch.equal(own, carried)


def _outside_close(cfg, got, want):
    """whisper80 at the resampled features' gate (8e-4), the other families
    at their own gate."""
    if cfg.features in ("plp", "spectrogram", "ssc"):
        assert_family_features_close(got, want, cfg.features)
    else:
        np.testing.assert_allclose(got, want, atol=RESAMPLED_FEATURE_ATOL, rtol=RESAMPLED_FEATURE_RTOL)


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_configs_outside_the_slice_raise(name):
    """Centered framing of resampled rows, which the port refused before,
    runs and matches the JAX package: three ragged int16 rows at 48 kHz
    (zero past each length) against `extract_batch(backend="jnp")`, and for
    whisper80 and ssc26 against `backend="pallas"` (interpret mode: the
    reference resamples, then its kernel reflects and frames), at the
    resampled gate or the family's; the masks equal."""
    tcfg = T_CONFIGS[name].replace(**OUTSIDE[name])
    jcfg = J_CONFIGS[name].replace(**OUTSIDE[name])
    assert tchain.unsupported_reason(tcfg) is None
    assert frontend.resample_route(tcfg) == "split"
    g = np.random.default_rng(sorted(OUTSIDE).index(name))
    utts = [np.round(g.standard_normal(n) * 3000) for n in (48000, 31111, 4801)]
    tb = tbatch.pad_batch(utts, tcfg, dtype="int16")
    jb = jpipeline.pad_batch(utts, jcfg)
    np.testing.assert_array_equal(tb.audio, jb.audio.astype(np.int16))
    feat, mask = tchain.extract_batch(tb.audio, tb.lengths, tcfg, device="cpu")
    assert feat.shape[:2] == mask.shape and torch.isfinite(feat).all()
    backends = ("jnp", "pallas") if name in OUTSIDE_PALLAS else ("jnp",)
    for backend in backends:
        jfeat, jmask = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg,
                                            backend=backend)
        F = feat.shape[1]
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask)[:, :F])
        _outside_close(tcfg, feat.numpy(), np.asarray(jfeat)[:, :F])


RESAMPLED_RATES = (22050, 32000, 44100, 48000, 96000, 192000)


def test_unsupported_reason_takes_every_resampled_row():
    """Every named config takes centered framing ("center" and
    "center_reflect") at 22.05-192 kHz input, and its own framing at 192 kHz
    input (the split route where the fused layout is over the block); n_fft
    6001, frames of 3 s, a 0.2 s hop and 170 cepstra at delta window 8,
    refused before, are taken with or without resampling (the gather plan,
    the tail's split plan); n_fft 3072 (the block FFT plan), 7001 and 16384
    (the packed bands read from device memory) and 32768 (the FFT rows in
    device memory too), refused before, are taken with or without
    resampling, and at 7001 with 48 kHz input the CPU chain ≡ the JAX jnp
    chain; 60,000 filters, refused before (over the packed mel table's
    filter field), are taken with or without resampling too (the wide
    plan; without it the projection's sums in device memory, "gather_sums"):
    nothing is refused on the default route."""
    for name in sorted(T_CONFIGS):
        for rate in RESAMPLED_RATES:
            for tail in ("center", "center_reflect"):
                cfg = T_CONFIGS[name].replace(input_sample_rate=rate, frame_tail=tail)
                assert tchain.unsupported_reason(cfg) is None, (name, rate, tail)
                assert frontend.resample_route(cfg) == "split"
        cfg = T_CONFIGS[name].replace(input_sample_rate=192000)
        assert tchain.unsupported_reason(cfg) is None and frontend.resample_route(cfg) == "split", name
    taken = [dict(n_fft=6001), dict(win_len_s=3.0), dict(hop_s=0.2),
             dict(n_mels=170, n_ceps=170, delta_window=8), dict(n_fft=3072), dict(n_fft=7001),
             dict(n_fft=16384), dict(n_fft=32768)]
    for over in taken:
        for rate in (None, 48000):
            cfg = T_CONFIGS["classic13_deltas"].replace(input_sample_rate=rate, **over)
            assert tchain.unsupported_reason(cfg) is None, (over, rate)
    for rate in (None, 48000):
        cfg = T_CONFIGS["classic13_deltas"].replace(input_sample_rate=rate, n_mels=60000)
        assert tchain.unsupported_reason(cfg) is None, rate
        assert frontend.fft_plan(frontend.feature_rate_config(cfg)) == "wide", rate
        assert frontend.fft_layout(frontend.feature_rate_config(cfg), wide=False)[0] == "gather_sums", rate
    tcfg = T_CONFIGS["classic13_deltas"].replace(input_sample_rate=48000, n_fft=7001)
    jcfg = J_CONFIGS["classic13_deltas"].replace(input_sample_rate=48000, n_fft=7001)
    g = np.random.default_rng(7001)
    x = np.round(g.standard_normal((2, 48000)) * 3000).astype(np.int16)
    lens = np.array([48000, 30011], np.int32)
    x[1, 30011:] = 0
    feat, mask = tchain.extract_batch(x, lens, tcfg, device="cpu")
    jfeat, jmask = jchain.extract_batch(jnp.asarray(x.astype(np.float32)), jnp.asarray(lens), jcfg,
                                        backend="jnp")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    _outside_close(tcfg, feat.numpy(), np.asarray(jfeat))
    assert frontend.resample_route(T_CONFIGS["mfcc39_48k"].replace(n_fft=3072)) == "split"
    assert frontend.resample_route(T_CONFIGS["mfcc39_48k"]) == "fused"
    assert frontend.resample_route(T_CONFIGS["classic13"]) is None


def test_default_device_is_the_card():
    """extract_batch runs on "cuda" unless told otherwise: with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = T_CONFIGS["classic13_deltas"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchain.extract_batch(np.zeros((1, 16000), np.int16), [16000], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfcc_tpu_torch.extract(np.zeros(16000, np.int16), cfg)


def test_extract_entry_point_matches_jax():
    sig = golden_signals()["speechish"]
    want = np.asarray(mfcc_tpu.extract(sig, "classic13_deltas"))
    got = mfcc_tpu_torch.extract(sig, "classic13_deltas", device="cpu")
    assert got.shape == want.shape
    assert_features_close(got.numpy(), want)
    pcm = np.round(sig * 3000)
    assert torch.equal(
        mfcc_tpu_torch.extract(pcm.astype(np.int16), "classic13", device="cpu"),
        mfcc_tpu_torch.extract(pcm, "classic13", device="cpu"),
    )
    # a wav path or its bytes are decoded, as the JAX package does
    demo = REPO / "demo.wav"
    want = np.asarray(mfcc_tpu.extract(str(demo), "classic13_deltas", backend="jnp"))
    got = mfcc_tpu_torch.extract(str(demo), "classic13_deltas", device="cpu")
    assert got.shape == want.shape
    assert_features_close(got.numpy(), want)
    assert torch.equal(mfcc_tpu_torch.extract(demo.read_bytes(), "classic13_deltas", device="cpu"), got)
    with pytest.raises(ValueError, match="expects 48000 Hz"):
        mfcc_tpu_torch.extract(demo, "mfcc39_48k", device="cpu")


def test_num_valid_frames_matches_jax():
    cfg = T_CONFIGS["classic13"]
    lens = [0, 1, 399, 400, 401, 560, 561, 16000, 40123]
    got = tchain.num_valid_frames(torch.tensor(lens), cfg).numpy()
    want = np.asarray(jchain.num_valid_frames(jnp.asarray(lens), J_CONFIGS["classic13"]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("F", [1, 2, 9])
def test_delta_matches_jax(F):
    """Δ with tail replication at n_valid, including utterances shorter than
    the regression window."""
    g = np.random.default_rng(F)
    feat = g.standard_normal((4, F, 5)).astype(np.float32)
    n_valid = np.array([F, max(F - 1, 0), 1, 0], np.int32)
    got = tchain.delta(torch.as_tensor(feat), torch.as_tensor(n_valid), T_CONFIGS["classic13"])
    want = jchain.delta(jnp.asarray(feat), jnp.asarray(n_valid), J_CONFIGS["classic13"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_bucket_helpers_match_jax():
    cfg = T_CONFIGS["classic13"]
    jcfg = J_CONFIGS["classic13"]
    for n in (0, 123, 400, 16000, 160000, 160001):
        assert tbatch.required_samples(n, cfg) == jpipeline.required_samples(n, jcfg)
    for max_s, nb in ((10.0, 4), (0.3, 4), (30.0, 6), (2.0, 1)):
        buckets = tbatch.make_buckets(max_s, cfg, nb)
        assert buckets == jpipeline.make_buckets(max_s, jcfg, nb)
        for n in (1, 8000, 40000, 10**7):
            assert tbatch.bucket_for(n, buckets) == jpipeline.bucket_for(n, buckets)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_pad_batch_matches_jax_flat_feed(dtype):
    cfg = T_CONFIGS["classic13_deltas"]
    utts = _pcm()
    want = jpipeline.pad_batch(
        utts, J_CONFIGS["classic13_deltas"], bucket_len=48000, pad_batch_to=6,
        ids=list("abcd"),
    )
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        got = tbatch.pad_batch(
            utts, cfg, bucket_len=48000, pad_batch_to=6, ids=list("abcd"),
            copy_pool=pool, dtype=dtype,
        )
    assert got.audio.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.audio, want.audio.astype(dtype))
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.ids == want.ids
    assert got.pad_occupancy == pytest.approx(want.pad_occupancy)


def test_pad_batch_errors_and_release():
    cfg = T_CONFIGS["classic13"]
    with pytest.raises(ValueError, match="empty"):
        tbatch.pad_batch([], cfg)
    with pytest.raises(ValueError, match="exceed bucket"):
        tbatch.pad_batch([np.ones(500)], cfg, bucket_len=400)
    with pytest.raises(ValueError, match="ids"):
        tbatch.pad_batch([np.ones(500)], cfg, ids=["a", "b"])
    released = []
    b = tbatch.pad_batch([np.ones(500)], cfg)
    b.on_release = released.append
    b.release()
    b.release()
    assert released == [b]


def test_port_imports_no_jax_and_no_mfcc_tpu():
    """`import mfcc_tpu_torch`, every module of the port, the CPU main path,
    the training path, the multi-process feed and the tools, in a fresh
    process (this one has jax loaded by conftest), leave jax and every
    mfcc_tpu module out of sys.modules."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "import mfcc_tpu_torch\n"
        "from mfcc_tpu_torch.kernels import frontend, resample, tail\n"
        "from mfcc_tpu_torch.ops import chain, dither, resample as rs\n"
        "from mfcc_tpu_torch.pipeline import pad_batch\n"
        "cfg = mfcc_tpu_torch.named_config('classic13_deltas')\n"
        "b = pad_batch([np.arange(5000) % 300 - 150], cfg, dtype='int16')\n"
        "feat, mask = chain.extract_batch(b.audio, b.lengths, cfg, device='cpu')\n"
        "assert tuple(feat.shape) == (1, 30, 39), feat.shape\n"
        "cfg = mfcc_tpu_torch.named_config('mfcc39_48k')\n"
        "b = pad_batch([np.arange(15000) % 300 - 150], cfg, dtype='int16')\n"
        "feat, mask = chain.extract_batch(b.audio, b.lengths, cfg, device='cpu')\n"
        "assert tuple(feat.shape) == (1, 30, 39), feat.shape\n"
        "y = rs.resample_batch(torch.ones((1, 4410)), 44100, 16000)\n"
        "assert tuple(y.shape) == (1, 1600), y.shape\n"
        "cfg = mfcc_tpu_torch.named_config('kaldi_mfcc').replace(dither=1.0)\n"
        "b = pad_batch([np.arange(5000) % 300 - 150], cfg, dtype='int16')\n"
        "feat, mask = chain.extract_batch(b.audio, b.lengths, cfg, device='cpu')\n"
        "assert tuple(feat.shape) == (1, 29, 13), feat.shape\n"
        "assert dither.signal_noise(0, 10, 160).shape == (10,)\n"
        "assert resample.launches == 0 and frontend.resample_launches == 0\n"
        "cfg = mfcc_tpu_torch.named_config('whisper80')\n"
        "b = pad_batch([np.arange(5000) % 300 - 150], cfg, dtype='int16')\n"
        "feat, mask = chain.extract_batch(b.audio, b.lengths, cfg, device='cpu')\n"
        "assert tuple(feat.shape) == (1, 32, 80), feat.shape\n"
        "assert frontend.dither_launches == 0 and frontend.conditioning_launches == 0\n"
        "assert frontend.centered_launches == 0 and frontend.block_fft_launches == 0\n"
        "cfg = mfcc_tpu_torch.named_config('classic13_deltas')\n"
        "b = pad_batch([np.arange(5000) % 300 - 150], cfg, dtype='int16')\n"
        "x, n = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)\n"
        "st = frontend.fused_logmel_stages(x, n, cfg, feature_tail=True, dft_passes='bf16x3')\n"
        "assert tuple(st['features_fused'].shape) == (1, 30, 39), st['features_fused'].shape\n"
        "assert tail.tail_launches == 0 and frontend.bf16x3_launches == 0\n"
        "import mfcc_tpu_torch.cli, mfcc_tpu_torch.cli.main, mfcc_tpu_torch.io, mfcc_tpu_torch.parallel\n"
        "import mfcc_tpu_torch.utils, mfcc_tpu_torch.utils.trace\n"
        "from mfcc_tpu_torch.io import htk, kaldi, reader, wav, writer\n"
        "from mfcc_tpu_torch.parallel import cmvn, extract, mesh\n"
        "from mfcc_tpu_torch.pipeline import longform\n"
        "feat = mfcc_tpu_torch.extract('demo.wav', 'classic13_deltas', device='cpu')\n"
        "assert tuple(feat.shape) == (249, 39), feat.shape\n"
        "cfg = mfcc_tpu_torch.named_config('classic13_deltas')\n"
        "x = np.arange(40000) % 300 - 150\n"
        "assert tuple(longform.extract_long(x, cfg, device='cpu', seg_len_s=0.5).shape) == (249, 39)\n"
        "m = mesh.data_mesh(device='cpu')\n"
        "f, k, mom = extract.sharded_extract_batch(b.audio, b.lengths, cfg, m, with_moments=True)\n"
        "assert tuple(mom[0].shape) == (39,)\n"
        "from mfcc_tpu_torch.pipeline import MultiStreamExtractor, StreamingExtractor, stream_features\n"
        "from mfcc_tpu_torch.pipeline import serving, streaming\n"
        "from mfcc_tpu_torch.ops.resample import StreamingResampler\n"
        "ex = StreamingExtractor(cfg, frames_per_block=16, device='cpu')\n"
        "assert ex.push(x[:20000]).shape[1] == 39 and ex.flush().shape[1] == 39\n"
        "pool = MultiStreamExtractor(cfg, 2, device='cpu')\n"
        "sid = pool.open(); pool.push(sid, x[:5000]); pool.end(sid)\n"
        "assert tuple(pool.poll()[sid].shape) == (30, 39)\n"
        "assert StreamingResampler(48000, 16000).push(np.ones(4800)).shape[0] > 0\n"
        "assert frontend.block_launches == 0 and tail.tail_launches == 0\n"
        "cli = __import__('importlib').import_module('mfcc_tpu_torch.cli.main')\n"
        "assert cli.build_parser().parse_args(['serve']).device == 'cuda'\n"
        "assert cli.build_parser().parse_args(['info', '--self-test']).device == 'cuda'\n"
        "assert cli.build_parser().parse_args(['convert', 'd', '-o', 'o', '--to', 'htk']).to == 'htk'\n"
        "a = torch.tensor(b.audio.astype(np.float32), requires_grad=True)\n"
        "f, m = chain.extract_batch_diff(a, b.lengths, cfg)\n"
        "(f ** 2).sum().backward()\n"
        "assert a.grad.shape == a.shape and not m.requires_grad\n"
        "from mfcc_tpu_torch import compat, viz\n"
        "from mfcc_tpu_torch.io import ShardDataset, SlabPool, dataset, feed_worker, stream_batches_mp\n"
        "from mfcc_tpu_torch.ops import reference_numpy\n"
        "from mfcc_tpu_torch.utils.trace import stage_times\n"
        "assert compat.as_config(winfunc=np.hamming).window == 'hamming_sym'\n"
        "assert reference_numpy.extract(x[:4000] * 1.0, cfg).shape == (24, 39)\n"
        "assert [len(mb.ids) for mb in stream_batches_mp(['demo.wav'], cfg, num_threads=1)] == [64]\n"
        "assert set(stage_times(b.audio, b.lengths, cfg, device='cpu', reps=1)) == "
        "{'preemph', 'logmel', 'full', 'features_minus_logmel'}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mfcc_tpu'))\n"
        "print(repr(bad))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("n_fft", [551, 404, 1102, 683, 256, 600])
def test_dft_basis_matches_rfft(n_fft):
    """The float64 DFT product the card's plain chain takes at an n_fft with
    a prime factor above 7 (`chain.power_spectrum`) ≡ rfft(n=n_fft), with
    frames zero-padded (L < n_fft) or truncated (L > n_fft)."""
    g = torch.Generator().manual_seed(n_fft)
    w = torch.randn(3, 7, 400, dtype=torch.float64, generator=g) * 1000
    basis = tchain.dft_basis(400, n_fft, torch.device("cpu"))
    nb = n_fft // 2 + 1
    assert basis.shape == (min(400, n_fft), 2 * nb) and basis.dtype == torch.float64
    reim = w[..., : basis.shape[0]] @ basis
    ref = torch.fft.rfft(w, n=n_fft, dim=-1)
    scale = float(ref.abs().max())
    assert float((reim[..., :nb] - ref.real).abs().max()) < 1e-12 * scale
    assert float((reim[..., nb:] - ref.imag).abs().max()) < 1e-12 * scale
    smooth = {256: True, 600: True, 551: False, 404: False, 1102: False, 683: False}
    assert tchain.smooth_fft_size(n_fft) is smooth[n_fft]
    assert all(tchain.smooth_fft_size(n) for n in (400, 480, 512, 2048, 7 * 9 * 25))
