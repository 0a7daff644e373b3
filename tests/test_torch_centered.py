"""The port's centered framing, whisper80 and the n_fft-generic front-end ≡
the JAX package's.

On the CPU, on the same numpy inputs: `reflect_index` (bitwise),
`frame_signal_centered`, `num_valid_frames` with `drop_last_frame`, the
`log10_floor` log and the Whisper norm of the torch chain against
`mfcc_tpu.ops.chain`; the front-end's plain version against the Pallas
kernel in interpret mode (whisper80's 400-point radix-4 route with its
reflect extension, the fp32 direct DFT at n_fft = 404) and the jnp stages;
features against the float64 oracle, the jnp and pallas-interpret chains
and the goldens; batching of centered configs against
`mfcc_tpu.pipeline`. Gates (`mfcc_tpu_torch.testing`):
  - reflect indices, frames and frame counts: exact;
  - float64 vs the oracle: 1e-10;
  - whisper80 features: 1e-5 fp32 vs the oracle on short signals, 5e-5
    against the fp32 JAX chains and the goldens (tests/test_librosa_whisper.py);
  - the [log-mel | energy] prefix: the kernel-vs-twin gates, log10 lanes
    taken to natural log;
  - Kaldi-convention features with centered framing: 5e-4 (mfcc), rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mfcc_tpu_torch
from mfcc_tpu import pipeline as jpipeline
from mfcc_tpu.config import FrontendConfig as JConfig
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.kernels import fused_logmel_stages
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.ops import reference_numpy as ref
from mfcc_tpu.testing.golden import golden_signals, load_golden
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import FrontendConfig as TConfig
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.pipeline import batch as tbatch

KINDS = ("center", "center_reflect")
WHISPER_LENGTHS = (32000, 15627, 801, 250, 90)  # 250 and 90: shorter than half a frame
GOLDENS = ("chirp", "dc", "impulse", "noise", "short", "speechish", "tone_bin",
           "tone_offbin", "zeros")


def _rows(lengths, seed, scale=8000.0):
    g = np.random.default_rng(seed)
    return [g.standard_normal(n) * scale for n in lengths]


def _features(tb, tcfg):
    feat, mask = tchain.extract_batch(tb.audio, tb.lengths, tcfg, device="cpu")
    return feat.numpy(), mask.numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 3, 250, 450])
def test_reflect_index_bitwise(kind, n):
    idx = np.arange(-3 * 450 - 7, 4 * 450 + 11)
    got = tchain.reflect_index(torch.as_tensor(idx), torch.tensor(n), kind).numpy()
    want = np.asarray(jchain.reflect_index(jnp.asarray(idx), jnp.asarray(n), kind))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("kind", KINDS)
def test_frame_signal_centered_matches_jax(kind):
    """Rows of 6000, 801, 250, 90, 1 and 0 samples: multi-wrap rows and a
    length-0 row (reflected at length 1) frame identically."""
    tcfg, jcfg = T_CONFIGS["classic13"].replace(frame_tail=kind), J_CONFIGS["classic13"].replace(frame_tail=kind)
    lens = np.array([6000, 801, 250, 90, 1, 0], np.int32)
    x = np.random.default_rng(3).standard_normal((len(lens), 6000)).astype(np.float32)
    F = tcfg.num_frames(6000)
    got = tchain.frame_signal_centered(torch.as_tensor(x), F, torch.as_tensor(lens), tcfg)
    want = jchain.frame_signal_centered(jnp.asarray(x), F, jnp.asarray(lens), jcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_num_valid_frames_matches_jax(kind, drop_last):
    lens = [0, 1, 79, 80, 159, 160, 199, 200, 399, 400, 401, 16000, 480000]
    tcfg = T_CONFIGS["classic13"].replace(frame_tail=kind, drop_last_frame=drop_last)
    jcfg = J_CONFIGS["classic13"].replace(frame_tail=kind, drop_last_frame=drop_last)
    got = tchain.num_valid_frames(torch.tensor(lens), tcfg).numpy()
    want = np.asarray(jchain.num_valid_frames(jnp.asarray(lens), jcfg))
    np.testing.assert_array_equal(got, want)
    assert [tcfg.num_frames(n) for n in lens[1:]] == list(got[1:])


@pytest.mark.parametrize("name,over", [("whisper80", {}), ("classic13", dict(frame_tail="center")),
                                       ("classic13", dict(drop_last_frame=True))],
                         ids=["whisper80", "center", "pad_drop_last"])
def test_pad_batch_matches_jax(name, over):
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    for n in (0, 90, 250, 400, 401, 16000, 16001, 480000):
        assert tbatch.required_samples(n, tcfg) == jpipeline.required_samples(n, jcfg)
    utts = [np.arange(n) % 300 - 150 for n in (90, 400, 16001, 5000)]
    want = jpipeline.pad_batch(utts, jcfg, pad_batch_to=6)
    got = tbatch.pad_batch(utts, tcfg, pad_batch_to=6)
    np.testing.assert_array_equal(got.audio, want.audio)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def _golden_batch(names=("noise", "speechish", "short", "tone_offbin", "chirp")):
    sigs = golden_signals()
    utts = [np.round(sigs[n] * 3000) for n in names]
    b = tbatch.pad_batch(utts, T_CONFIGS["whisper80"], dtype="int16")
    return b.audio, b.lengths


def test_whisper80_prefix_matches_pallas_interpret():
    """The plain version ≡ the Pallas kernel (400-point radix-4 at N2 = 100,
    the reflect extension, the log10_floor epilogue) on the golden signals'
    valid frames (the Pallas kernel's boundary-only extension leaves the
    frames past a row's valid count unreflected; they are masked): within
    the reference's gates between two DFT routes, since its radix-4 at
    N2 = 100 is itself 1.1e-5 of the row max from float64 in the linear
    domain; and the plain version within all the prefix gates of float64."""
    audio, lengths = _golden_batch()
    cfg = T_CONFIGS["whisper80"]
    F = cfg.num_frames(audio.shape[1])
    fused = fused_logmel_stages(jnp.asarray(audio, jnp.float32), jnp.asarray(lengths),
                                J_CONFIGS["whisper80"], interpret=True)
    want = np.asarray(fused["prefix_fp"])[:, :F]
    got = frontend.logmel_prefix_reference(torch.as_tensor(audio), torch.as_tensor(lengths), cfg)
    assert got.shape == (len(lengths), F, cfg.n_mels + 1)
    valid = tchain.frame_mask(tchain.num_valid_frames(torch.as_tensor(lengths), cfg), F,
                              torch.float32).numpy() > 0
    errs = testing.prefix_errors(got.numpy()[valid], want[valid], cfg.n_mels, cfg.log_kind)
    assert errs["logmel_loud_max_abs"] < 2e-5 and errs["energy_max_rel"] < 1e-5, errs
    want64 = frontend.logmel_prefix_reference(torch.as_tensor(audio), torch.as_tensor(lengths),
                                              cfg.replace(dtype="float64"))
    testing.assert_prefix_close(got, want64, cfg.n_mels, cfg.log_kind)


def test_whisper80_prefix_matches_jnp_stages():
    audio, lengths = _golden_batch()
    cfg = T_CONFIGS["whisper80"]
    twin = jchain.logmel_stages(jnp.asarray(audio), jnp.asarray(lengths), J_CONFIGS["whisper80"])
    want = np.concatenate([np.asarray(twin["logmel"]), np.asarray(twin["energy"])[..., None]], -1)
    got = frontend.logmel_prefix_reference(torch.as_tensor(audio), torch.as_tensor(lengths), cfg)
    testing.assert_prefix_close(got, want, cfg.n_mels, cfg.log_kind)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_whisper80_features_match_jax(backend):
    """Lengths [32000, 15627, 801, 250, 90] (the reference's multi-wrap
    batch): features within 5e-5 of the JAX chain, the mask equal."""
    tcfg, jcfg = T_CONFIGS["whisper80"], J_CONFIGS["whisper80"]
    utts = _rows(WHISPER_LENGTHS, 5)
    tb = tbatch.pad_batch(utts, tcfg)
    jb = jpipeline.pad_batch(utts, jcfg)
    jf, jm = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg, backend=backend)
    feat, mask = _features(tb, tcfg)
    np.testing.assert_array_equal(mask, np.asarray(jm))
    testing.assert_whisper_features_close(feat, np.asarray(jf))
    np.testing.assert_array_equal(feat[mask == 0], 0.0)


def test_whisper80_float32_matches_oracle():
    tcfg = T_CONFIGS["whisper80"]
    utts = _rows((16000, 16000 - 373, 801, 450, 250, 16000 * 2 + 7), 23)
    feat, _ = _features(tbatch.pad_batch(utts, tcfg), tcfg)
    for i, x in enumerate(utts):
        want = ref.extract(x, J_CONFIGS["whisper80"])
        testing.assert_whisper_features_close(feat[i, : len(want)], want, testing.WHISPER_ORACLE_ATOL)


@pytest.mark.parametrize("n", [16000 + 137, 450, 799, 90])
def test_whisper80_float64_exact_vs_oracle(n):
    cfg = T_CONFIGS["whisper80"].replace(dtype="float64")
    x = np.random.default_rng(n).standard_normal(n) * 8000.0
    want = ref.extract(x, J_CONFIGS["whisper80"].replace(dtype="float64"))
    got = mfcc_tpu_torch.extract(x, cfg, device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("signal_name", GOLDENS)
def test_whisper80_golden_parity(signal_name):
    """Every golden within 5e-5; the chirp, one of whose bins lies 7.8
    decades below its max (5.6e-5 there: torch's CPU float32 rfft), within
    the two-regime whisper gate (mfcc_tpu_torch/testing.py)."""
    g = load_golden("whisper80", signal_name)
    got = mfcc_tpu_torch.extract(g["signal"].astype(np.float32), "whisper80", device="cpu")
    assert tuple(got.shape) == g["features"].shape
    errs = testing.whisper_feature_errors(got, g["features"])
    assert not testing.whisper_feature_failures(errs), errs
    if signal_name != "chirp":
        testing.assert_whisper_features_close(got, g["features"])


def test_whisper_norm_is_padding_invariant():
    """The max-8 clamp takes the max over VALID frames: the same utterance
    beside a louder one and in a longer bucket gives the same features."""
    cfg = T_CONFIGS["whisper80"]
    g = np.random.default_rng(29)
    x = (g.standard_normal(16000) * 3000).astype(np.float32)
    loud = (g.standard_normal(32000) * 30000).astype(np.float32)
    f1, _ = _features(tbatch.pad_batch([x], cfg, bucket_len=16000), cfg)
    f2, _ = _features(tbatch.pad_batch([x, loud], cfg, bucket_len=32000), cfg)
    fv = cfg.num_frames(16000)
    np.testing.assert_allclose(f1[0, :fv], f2[0, :fv], rtol=0, atol=2e-6)


def test_whisper_norm_after_drop_last_frame():
    """drop_last_frame removes the last frame from the valid set, so a loud
    burst in it does not raise the clamp: the norm equals the one computed
    from the valid frames alone, and matches the JAX chain."""
    tcfg, jcfg = T_CONFIGS["whisper80"], J_CONFIGS["whisper80"]
    x = np.random.default_rng(31).standard_normal(16000) * 100.0
    x[-80:] *= 300.0  # only the dropped last frame sees all of it
    tb = tbatch.pad_batch([x], tcfg)
    st = tchain.logmel_stages(torch.as_tensor(tb.audio), torch.as_tensor(tb.lengths), tcfg)
    feat = tchain.features_from_logmel(st, tcfg).numpy()[0]
    nv = int(st["n_valid"][0])
    lm = st["logmel"].numpy()[0, :nv]
    want = (np.maximum(lm, lm.max() - 8.0) + 4.0) / 4.0
    np.testing.assert_allclose(feat[:nv], want, rtol=0, atol=1e-6)
    assert st["logmel"].numpy()[0, nv:].max() > lm.max()  # the dropped frame is louder
    jb = jpipeline.pad_batch([x], jcfg)
    jf, _ = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg)
    testing.assert_whisper_features_close(feat, np.asarray(jf)[0])


@pytest.mark.parametrize("over", [{}, dict(dither=1.0), dict(preemph=0.0, features="logmel",
                                                             append_energy=False, lifter=0)],
                         ids=["preemph", "preemph_dither", "logmel_no_preemph"])
def test_center_mode_matches_jnp_chain(over):
    """FrontendConfig(frame_tail="center") (Kaldi snip_edges=false) with
    signal pre-emphasis, which the reference applies before it reflects,
    and with dither, whose noise precedes the reflection: the port's chain
    within 5e-4 of the jnp chain, on rows shorter than half a frame too."""
    tcfg, jcfg = TConfig(frame_tail="center", **over), JConfig(frame_tail="center", **over)
    utts = _rows((16000, 801, 250, 90), 37, 300.0)
    tb, jb = tbatch.pad_batch(utts, tcfg), jpipeline.pad_batch(utts, jcfg)
    feat, mask = _features(tb, tcfg)
    jf, jm = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg)
    np.testing.assert_array_equal(mask, np.asarray(jm))
    testing.assert_features_close(feat, np.asarray(jf))


@pytest.mark.parametrize("name", ["center_tail", "center_no_preemph", "center_reflect_deltas"])
def test_centered_variants_fp64_exact(name):
    """The centered variants of tests/test_kaldi_conventions.py and of the
    reference's reflect-deltas case, float64 against the oracle."""
    base, over = {
        "center_tail": ("kaldi_mfcc", dict(frame_tail="center")),
        "center_no_preemph": ("kaldi_mfcc", dict(frame_tail="center", preemph=0.0)),
        "center_reflect_deltas": ("classic13", dict(frame_tail="center_reflect", deltas=2)),
    }[name]
    tcfg = T_CONFIGS[base].replace(dtype="float64", **over)
    jcfg = J_CONFIGS[base].replace(dtype="float64", **over)
    for n in (32000 + 137, 400, 100, 16000):
        x = np.random.default_rng(n).standard_normal(n) * 1000
        want = ref.extract(x, jcfg)
        got = mfcc_tpu_torch.extract(x, tcfg, device="cpu")
        assert tuple(got.shape) == want.shape, (name, n)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=1e-10)


def test_kaldi_center_with_dither_matches_jnp_chain():
    """kaldi_mfcc centered with Kaldi's default dither: the noise is keyed on
    the source index, before the reflection, in both packages."""
    tcfg = T_CONFIGS["kaldi_mfcc"].replace(frame_tail="center", dither=1.0)
    jcfg = J_CONFIGS["kaldi_mfcc"].replace(frame_tail="center", dither=1.0)
    utts = _rows((16000, 801, 250), 41, 300.0)
    tb, jb = tbatch.pad_batch(utts, tcfg), jpipeline.pad_batch(utts, jcfg)
    feat, _ = _features(tb, tcfg)
    jf, _ = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg)
    testing.assert_kaldi_features_close(feat, np.asarray(jf), tcfg)


def test_direct_dft_prefix_matches_pallas_fp32():
    """classic13 at n_fft = 404 (404/2 = 2·101: no Stockham plan; the
    kernel takes the Bluestein form, which replaced the direct DFT at this
    size) ≡ the Pallas kernel's fp32 direct-DFT route, `_make_kernel`."""
    tcfg, jcfg = T_CONFIGS["classic13"].replace(n_fft=404), J_CONFIGS["classic13"].replace(n_fft=404)
    assert frontend.dft_form(tcfg) == "bluestein" and frontend.resolve_dft_passes(tcfg) == "fp32"
    sigs = golden_signals()
    utts = [sigs[n] for n in ("noise", "speechish", "short", "tone_offbin")]
    b = jpipeline.pad_batch(utts, jcfg, bucket_len=max(u.shape[0] for u in utts))
    F = tcfg.num_frames(b.audio.shape[1])
    fused = fused_logmel_stages(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg,
                                dft_passes="fp32", interpret=True)
    want = np.asarray(fused["prefix_fp"])[:, :F]
    audio, lengths = torch.as_tensor(b.audio), torch.as_tensor(b.lengths)
    got = frontend.logmel_prefix_reference(audio, lengths, tcfg)
    # the reference's gates between its two DFT routes (test_pallas_kernels.py
    # ::test_radix4_matches_direct_fp32): its fp32 DFT matmul is itself 1.1e-5
    # of the row max from float64 in the linear domain, where this is 1.8e-6
    errs = testing.prefix_errors(got, want, tcfg.n_mels)
    assert errs["logmel_loud_max_abs"] < 2e-5 and errs["energy_max_rel"] < 1e-5, errs
    want64 = frontend.logmel_prefix_reference(audio, lengths, tcfg.replace(dtype="float64"))
    testing.assert_prefix_close(got, want64, tcfg.n_mels)


@pytest.mark.parametrize("n_fft", [404, 480])
def test_other_n_fft_features_match_jnp_chain(n_fft):
    tcfg = T_CONFIGS["classic13_deltas"].replace(n_fft=n_fft)
    jcfg = J_CONFIGS["classic13_deltas"].replace(n_fft=n_fft)
    utts = _rows((16000, 5003, 401), 43, 3000.0)
    tb, jb = tbatch.pad_batch(utts, tcfg), jpipeline.pad_batch(utts, jcfg)
    feat, _ = _features(tb, tcfg)
    jf, _ = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg)
    testing.assert_features_close(feat, np.asarray(jf))


def test_frames_longer_than_nfft_with_conditioning():
    """kaldi_mfcc with 40 ms frames at n_fft = 512 (L = 640): the port now
    takes it (ROADMAP queue 2 item 3): all L samples conditioned, the first
    512 transformed. Features within 5e-4 of the jnp chain, the prefix
    within the gates of the pallas-interpret kernel, which widens its chunk
    window for it."""
    tcfg = T_CONFIGS["kaldi_mfcc"].replace(win_len_s=0.040, n_fft=512)
    jcfg = J_CONFIGS["kaldi_mfcc"].replace(win_len_s=0.040, n_fft=512)
    assert tchain.unsupported_reason(tcfg) is None and tcfg.frame_length == 640
    sigs = golden_signals()
    utts = [np.round(sigs[n] * 3000) for n in ("noise", "speechish", "short")]
    tb, jb = tbatch.pad_batch(utts, tcfg), jpipeline.pad_batch(utts, jcfg)
    feat, _ = _features(tb, tcfg)
    jf, _ = jchain.extract_batch(jnp.asarray(jb.audio), jnp.asarray(jb.lengths), jcfg)
    testing.assert_kaldi_features_close(feat, np.asarray(jf), tcfg)
    F = tcfg.num_frames(tb.audio.shape[1])
    fused = fused_logmel_stages(jnp.asarray(tb.audio), jnp.asarray(tb.lengths), jcfg, interpret=True)
    got = frontend.logmel_prefix_reference(torch.as_tensor(tb.audio), torch.as_tensor(tb.lengths), tcfg)
    valid = tb.lengths >= tcfg.frame_length
    testing.assert_prefix_close(got.numpy()[valid], np.asarray(fused["prefix_fp"])[:, :F][valid],
                                tcfg.n_mels, tcfg.log_kind)


def test_whisper80_extract_single_matches_jax():
    x = np.random.default_rng(47).standard_normal(24011) * 5000.0
    got = mfcc_tpu_torch.extract(x.astype(np.float32), "whisper80", device="cpu")
    want = jchain.extract_single(x.astype(np.float32), J_CONFIGS["whisper80"])
    assert tuple(got.shape) == want.shape == (T_CONFIGS["whisper80"].num_frames(24011), 80)
    testing.assert_whisper_features_close(got, want)


def test_whisper80_short_batch_gives_no_frames():
    """Rows under one hop give F = 0 under center_reflect with the last
    frame dropped: empty features, no error from the norm's max (the JAX
    package's jnp.max raises on the empty frame axis, ROADMAP queue 3)."""
    cfg = T_CONFIGS["whisper80"]
    feat, mask = tchain.extract_batch(np.zeros((2, 150), np.int16), [150, 0], cfg, device="cpu")
    assert tuple(feat.shape) == (2, 0, 80) and tuple(mask.shape) == (2, 0)


def test_narrow_lanes_take_the_per_bin_gate():
    """whisper80's Slaney filters at n_fft 400 are narrow (at most two
    weights) on 34 of 80 lanes, the 512-point psf and Kaldi banks on none;
    with the narrow lanes given, a loud-bin error of 5e-5 on one of them
    passes the per-bin 1e-4 gate, and the same error on a wide lane fails
    the 2e-5 gate of a filter sum."""
    def narrow_of(name):
        mel = tchain.device_constants(T_CONFIGS[name], torch.device("cpu"), torch.float64)["mel"]
        return testing.narrow_lanes(mel)

    narrow = narrow_of("whisper80")
    assert narrow.shape == (80,) and int(narrow.sum()) == 34 and narrow[0]
    assert not narrow_of("classic13").any() and not narrow_of("kaldi_mfcc").any()
    g = np.random.default_rng(53)
    lin = np.exp(g.uniform(0, 5, size=(2, 7, 80)))
    want = np.concatenate([np.log10(lin), lin.sum(-1, keepdims=True)], -1)
    wide = int(np.flatnonzero(~narrow)[0])
    for lane, ok in ((0, True), (wide, False)):
        got = want.copy()
        got[0, 3, lane] += 5e-5 / np.log(10)
        errs = testing.prefix_errors(got, want, 80, "log10_floor", narrow=narrow)
        assert bool(testing.prefix_failures(errs)) != ok, errs
