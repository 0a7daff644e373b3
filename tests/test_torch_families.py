"""The port's PLP, spectrogram and SSC families ≡ the JAX package's.

kaldi_plp, kaldi_spectrogram and ssc26 on the CPU, the same numpy inputs
through both packages:
  - `durbin`, `lpc_to_cepstrum` and `plp_base` against `mfcc_tpu.ops.chain`
    under x64 and the float64 oracle: 1e-12;
  - each family (and the kaldi_plp variants of tests/test_plp.py) in
    float64 against `mfcc_tpu.ops.reference_numpy.extract`: 1e-10;
  - fp32 features against the jnp chain, the goldens against the frozen
    oracle, at the JAX tests' family gates (`mfcc_tpu_torch.testing`
    FAMILY_GATES). The chirp golden (all three PLP/spectrogram gates) and
    PLP's off-bin tone are left out, as the JAX tests leave them out: their
    quiet bins sit at the fp32 floor, where the jnp chain misses the same
    gates by as much;
  - the front-end's plain version against the Pallas kernel's prefix in
    interpret mode, at the family's prefix gate;
  - the prefix path (what the card feeds) ≡ the stage path, masking
    invariance, int16 ≡ float32 and dirty tails bitwise, and SSC on all-zero
    input, where the per-bin clamp alone sets the centroids.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mfcc_tpu_torch
from mfcc_tpu import pipeline as jpipeline
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.kernels import fused_logmel_stages
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.ops import constants as jconstants
from mfcc_tpu.ops import reference_numpy as ref
from mfcc_tpu.testing.golden import golden_signals, load_golden
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.pipeline import batch as tbatch
from tests.test_torch_frontend import _emulate_kernel

FAMILIES = ("kaldi_plp", "kaldi_spectrogram", "ssc26")
LENGTHS = (32000 + 137, 400, 100, 16000)  # 100 < L: no frames under "drop"
# tests/test_plp.py::test_plp_variants_fp64_exact
PLP_VARIANTS = {
    "deltas": dict(deltas=2),
    "no_energy": dict(append_energy=False),
    "energy_floor": dict(energy_floor=1e-3),
    "order16": dict(lpc_order=16, n_ceps=17),
    "compress_half": dict(compress_factor=0.5),
    "vtln": dict(vtln_warp=1.1),
    "utt_cmvn": dict(cmvn="utterance", deltas=1),
}
GOLDEN_SIGNALS = {
    "kaldi_plp": ("dc", "impulse", "noise", "short", "speechish", "tone_bin", "zeros"),
    "kaldi_spectrogram": ("dc", "impulse", "noise", "short", "speechish", "tone_bin",
                          "tone_offbin", "zeros"),
    "ssc26": tuple(sorted(golden_signals())),
}
SRC = pathlib.Path(frontend.__file__).resolve().parent / "csrc" / "frontend.cu"


def _valid_autocorr(g, rows: int, p1: int) -> np.ndarray:
    """Positive-definite autocorrelation rows (tests/test_plp.py), plus an
    all-zero row (padding frames)."""
    spec = np.abs(g.standard_normal((rows, 64))) ** 2 + 0.1
    full = np.concatenate([spec, spec[:, -2:0:-1]], axis=1)
    r = np.fft.irfft(full, axis=1)[:, :p1]
    return np.concatenate([r, np.zeros((1, p1))])


@pytest.mark.parametrize("order", [1, 12, 16])
def test_durbin_and_cepstra_match_jax(order):
    r = _valid_autocorr(np.random.default_rng(order), 8, order + 1)
    a, e = tchain.durbin(torch.as_tensor(r), order)
    c = tchain.lpc_to_cepstrum(a)
    with jax.enable_x64(True):
        ja, je = jchain.durbin(jnp.asarray(r), order)
        jc = jchain.lpc_to_cepstrum(ja)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-12, atol=1e-12)
    ra, re_ = ref.durbin(r)
    np.testing.assert_allclose(a.numpy(), ra, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(e.numpy(), re_, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(c.numpy(), ref.lpc_to_cepstrum(ra), rtol=1e-12, atol=1e-12)
    assert not a[-1].any() and float(e[-1]) == 0.0  # all-zero row: a = 0, E = 0


@pytest.mark.parametrize("variant", ["kaldi_plp", "energy_floor", "no_energy", "order16"])
def test_plp_base_matches_jax(variant):
    over = PLP_VARIANTS.get(variant, {})
    tcfg = T_CONFIGS["kaldi_plp"].replace(dtype="float64", **over)
    jcfg = J_CONFIGS["kaldi_plp"].replace(dtype="float64", **over)
    g = np.random.default_rng(7)
    mel = np.abs(g.standard_normal((3, 5, tcfg.n_mels))) ** 2 * 1e6
    mel[0, 0] = 0.0  # a silent frame
    energy = np.maximum(mel.sum(-1), tcfg.log_eps)
    got = tchain.plp_base(torch.as_tensor(mel), torch.as_tensor(energy), tcfg).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jchain.plp_base(jnp.asarray(mel), jnp.asarray(energy), jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    k = jconstants.chain_constants(jcfg)
    oracle = np.stack([ref.plp_base(m, e, jcfg, k) for m, e in zip(mel, energy)])
    np.testing.assert_allclose(got, oracle, rtol=1e-12, atol=1e-12)


FP64_CASES = [(n, {}) for n in FAMILIES] + [("kaldi_plp", v) for v in PLP_VARIANTS.values()] + [
    ("kaldi_spectrogram", dict(energy_floor=1e-3)),
    ("ssc26", dict(deltas=2, cmvn="utterance")),
]
FP64_IDS = list(FAMILIES) + [f"plp_{v}" for v in PLP_VARIANTS] + [
    "spectrogram_energy_floor", "ssc26_deltas_cmvn"]


@pytest.mark.parametrize("name,over", FP64_CASES, ids=FP64_IDS)
def test_family_fp64_exact_vs_oracle(name, over):
    tcfg = T_CONFIGS[name].replace(dtype="float64", **over)
    jcfg = J_CONFIGS[name].replace(dtype="float64", **over)
    for n in LENGTHS:
        x = np.random.default_rng(n).standard_normal(n) * 1000
        want = ref.extract(x, jcfg)
        got = mfcc_tpu_torch.extract(x, tcfg, device="cpu")
        assert got.dtype == torch.float64 and tuple(got.shape) == want.shape, (n, got.shape)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=1e-10, err_msg=f"n={n}")


def _two_rows():
    g = np.random.default_rng(11)
    x = np.stack([
        g.standard_normal(32000).astype(np.float32) * 300,
        np.concatenate([g.standard_normal(9000).astype(np.float32) * 300,
                        np.zeros(32000 - 9000, np.float32)]),
    ])
    return x, np.array([32000, 9000], np.int32)


@pytest.mark.parametrize("name", FAMILIES)
def test_fp32_matches_jnp_chain_and_oracle(name):
    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    x, lens = _two_rows()
    jf, jm = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="jnp")
    tf, tm = tchain.extract_batch(x, lens, tcfg, device="cpu")
    assert tf.shape == jf.shape
    testing.assert_family_features_close(tf, np.asarray(jf), tcfg.features)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for i, n in enumerate(lens):
        want = ref.extract(x[i, :n].astype(np.float64), jcfg)
        testing.assert_family_features_close(tf[i, : len(want)], want, tcfg.features, "float64")


GOLDEN_CASES = [(c, s) for c in FAMILIES for s in GOLDEN_SIGNALS[c]]


@pytest.mark.parametrize("config_name,signal_name", GOLDEN_CASES)
def test_golden_parity(config_name, signal_name):
    g = load_golden(config_name, signal_name)
    cfg = T_CONFIGS[config_name]
    feat = mfcc_tpu_torch.extract(g["signal"].astype(np.float32), cfg, device="cpu")
    assert tuple(feat.shape) == g["features"].shape
    testing.assert_family_features_close(feat, g["features"], cfg.features, "golden")


def _golden_batch(names=("noise", "speechish", "short", "tone_offbin"), scale=3000.0):
    sigs = golden_signals()
    chosen = [sigs[n] * scale for n in names]
    b = jpipeline.pad_batch(chosen, J_CONFIGS["kaldi_mfcc"], bucket_len=max(len(c) for c in chosen))
    return b.audio, b.lengths


PREFIX_CASES = [(n, {}) for n in FAMILIES] + [("ssc26", dict(remove_dc_offset=True, dither=0.5))]


@pytest.mark.parametrize("name,over", PREFIX_CASES, ids=list(FAMILIES) + ["ssc26_dc_dither"])
def test_reference_matches_pallas_prefix(name, over):
    """The kernel's plain version ≡ the Pallas kernel (interpret mode), lane
    for lane: [melspec | energy], [log pspec | energy], [centroids | 0]."""
    audio, lengths = _golden_batch()
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    F = tcfg.num_frames(audio.shape[1])
    fused = fused_logmel_stages(jnp.asarray(audio), jnp.asarray(lengths), jcfg, interpret=True)
    want = np.asarray(fused["prefix_fp"])[:, :F]
    got = frontend.logmel_prefix_reference(torch.as_tensor(audio), torch.as_tensor(lengths), tcfg)
    assert tuple(got.shape) == (4, F, tcfg.n_mels + 1)
    valid = lengths > 0
    testing.assert_prefix_close(got.numpy()[valid], want[valid], tcfg.n_mels, tcfg.log_kind,
                                tcfg.features)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefix_path_equals_stage_path(name):
    """features_from_logmel on the kernel's prefix (the card's path) ≡ on
    the plain chain's stages (the CPU path), within the family's fp32 gate."""
    cfg = T_CONFIGS[name]
    audio, lengths = _golden_batch()
    audio, lengths = torch.as_tensor(audio), torch.as_tensor(lengths)
    stages = tchain.logmel_stages(audio, lengths, cfg)
    prefix = frontend.logmel_prefix(audio, lengths, cfg)
    via_prefix = tchain.features_from_logmel(
        {"prefix": prefix, "n_valid": stages["n_valid"], "frame_mask": stages["frame_mask"]}, cfg)
    testing.assert_family_features_close(via_prefix, tchain.features_from_logmel(stages, cfg),
                                         cfg.features)


@pytest.mark.parametrize("name", FAMILIES)
def test_masking_invariance(name):
    """An utterance inside a padded batch gives the same bytes on its valid
    frames as alone at the same T, and exact zeros on pad frames. PLP is
    held within 2e-5, as tests/test_plp.py::test_plp_masking_invariance
    holds it: torch's CPU pow takes a vector path and a scalar tail that
    differ by ulps, so an element's result depends on its place in the
    batch, and Durbin amplifies that."""
    cfg = T_CONFIGS[name]
    sigs = golden_signals()
    utts = [np.round(sigs[n] * 3000) for n in ("noise", "short", "speechish", "tone_offbin")]
    b = tbatch.pad_batch(utts, cfg, dtype="int16")
    feat, mask = tchain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    atol = 2e-5 if cfg.features == "plp" else 0.0
    for i, u in enumerate(utts):
        fv = cfg.num_frames(u.shape[0])
        alone = np.zeros((1, b.audio.shape[1]), np.int16)
        alone[0, : u.shape[0]] = u
        feat_s, _ = tchain.extract_batch(alone, [u.shape[0]], cfg, device="cpu")
        np.testing.assert_allclose(feat[i, :fv].numpy(), feat_s[0, :fv].numpy(), rtol=0, atol=atol)
        assert bool(mask[i, :fv].all()) and not bool(mask[i, fv:].any())
        np.testing.assert_array_equal(feat[i, fv:].numpy(), 0.0)


@pytest.mark.parametrize("name", FAMILIES)
def test_int16_rows_and_dirty_tails_bitwise(name):
    cfg = T_CONFIGS[name]
    g = np.random.default_rng(5)
    pcm = (g.standard_normal((3, 9000)) * 3000).astype(np.int16)
    lengths = torch.tensor([9000, 5000, 399], dtype=torch.int32)
    clean = pcm.copy()
    clean[1, 5000:] = 0
    clean[2, 399:] = 0
    got = frontend.logmel_prefix(torch.as_tensor(pcm), lengths, cfg)
    assert torch.equal(got, frontend.logmel_prefix(torch.as_tensor(clean), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(torch.as_tensor(clean.astype(np.float32)),
                                                   lengths, cfg))


def test_ssc_zeros_golden_is_the_per_bin_clamp():
    """On all-zero input every power bin is exactly 0, so the per-bin clamp
    alone sets the centroids: Σ f·mel / Σ mel per filter. The plain
    version, the kernel's numpy mirror and the golden agree on it."""
    cfg = T_CONFIGS["ssc26"]
    g = load_golden("ssc26", "zeros")
    k = jconstants.chain_constants(J_CONFIGS["ssc26"])
    clamp = (k["freqs"] @ k["mel"]) / k["mel"].sum(axis=0)  # eps cancels
    np.testing.assert_allclose(g["features"], np.broadcast_to(clamp, g["features"].shape),
                               rtol=1e-12)
    n = g["signal"].shape[0]
    audio = torch.zeros((2, n), dtype=torch.int16)
    lengths = torch.tensor([n, n // 2], dtype=torch.int32)
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg).numpy()
    mirror = _emulate_kernel(audio.numpy(), lengths.numpy(), cfg, np.float32)
    for got in (plain, mirror):
        np.testing.assert_allclose(got[..., :-1], np.broadcast_to(clamp, got[..., :-1].shape),
                                   rtol=2e-6)
        np.testing.assert_array_equal(got[..., -1], 0.0)
    feat = mfcc_tpu_torch.extract(g["signal"].astype(np.float32), cfg, device="cpu")
    testing.assert_family_features_close(feat, g["features"], "ssc", "golden")


def test_prefix_gates_by_family():
    """PLP lanes are raw energies (a log reading would overflow exp); SSC
    lanes are centroids in Hz under rtol 1e-4, atol 5e-3."""
    g = np.random.default_rng(2)
    mel = np.abs(g.standard_normal((3, 5, 4))) * 1e9
    want = np.concatenate([mel, mel.sum(-1, keepdims=True)], -1)
    got = want.copy()
    got[..., :4] += 5e-6 * mel.max(-1, keepdims=True)
    testing.assert_prefix_close(got, want, 4, features="plp")
    got[0, 0, 0] += 1e-5 * mel[0, 0].max()
    with pytest.raises(AssertionError, match="linear_rel_rowmax"):
        testing.assert_prefix_close(got, want, 4, features="plp")
    cents = np.concatenate([g.uniform(100, 8000, (3, 5, 4)), np.zeros((3, 5, 1))], -1)
    near = cents.copy()
    near[..., :4] += 4e-3 + 1e-4 * cents[..., :4]
    testing.assert_prefix_close(near, cents, 4, features="ssc")
    near[0, 0, 0] += 2e-3
    with pytest.raises(AssertionError, match="centroid_excess"):
        testing.assert_prefix_close(near, cents, 4, features="ssc")
    near[0, 0, 0] -= 2e-3
    near[0, 0, 4] = 1.0  # lane M must stay 0
    with pytest.raises(AssertionError, match="energy_max_rel"):
        testing.assert_prefix_close(near, cents, 4, features="ssc")


def test_spectrogram_feature_gate_reads_bins_two_regime():
    """Between fp32 chains a spectrogram's log power bins take the
    two-regime gate (a bin 1e-10 below its row's max may differ by 4e-3 in
    its log), lane 0 the JAX gate; the goldens hold every lane to 2e-4 /
    1e-3."""
    g = np.random.default_rng(3)
    want = np.log(np.abs(g.standard_normal((2, 6, 257))) ** 2 * 1e9)
    want[..., 5] = want[..., 6:].max() - np.log(1e10)  # a quiet bin
    got = want.copy()
    got[..., 5] += 5e-3
    testing.assert_family_features_close(got, want, "spectrogram")
    with pytest.raises(AssertionError, match=r"max\(\|diff\|"):
        testing.assert_family_features_close(got, want, "spectrogram", "golden")
    got[0, 0, 6:] += 2e-4  # loud bins
    with pytest.raises(AssertionError, match="logmel_loud_max_abs"):
        testing.assert_family_features_close(got, want, "spectrogram")
    lane0 = want.copy()
    lane0[..., 0] += 3e-3 + 2e-3 * np.abs(want[..., 0])
    with pytest.raises(AssertionError, match=r"max\(\|diff\|"):
        testing.assert_family_features_close(lane0, want, "spectrogram")


def test_kernel_tables_and_layout():
    """The wrapper's feature-kind codes are the kernel's; SSC's melf is
    f_k·mel[k, m] rounded once from float64, packed as mel is; the
    shared-memory layout stages no weights for the spectrogram and two
    packed tables for SSC."""
    enum = re.search(r"enum \{ (kLogmel = 0.*?) \};", SRC.read_text()).group(1)
    codes = [name for name, _ in re.findall(r"k(\w+) = (\d)", enum)]
    assert [c.lower() for c in codes] == list(frontend.FEATURE_KINDS)
    cfg = T_CONFIGS["ssc26"]
    k = frontend._device_tables(cfg, torch.device("cpu"))
    host = jconstants.chain_constants(J_CONFIGS["ssc26"])
    _, index = frontend.mel_packed(torch.as_tensor(host["mel"].astype(np.float32)))
    np.testing.assert_array_equal(
        k["melf_w"].numpy(), (host["freqs"][:, None] * host["mel"]).astype(np.float32).reshape(-1)[index])
    np.testing.assert_array_equal(k["mel_w"].numpy(), host["mel"].astype(np.float32).reshape(-1)[index])
    span = 31 * 160 + 400  # the 32-frame tile's samples
    # signal, window, twiddles (the split's 129 and the stages' 224 + 192
    # float2), the stages' 128 output bases, two padded rows a warp
    rest = span + 512 + 1092 + 128 + 2 * 580 * 8
    assert frontend.smem_bytes(T_CONFIGS["kaldi_spectrogram"]) == 4 * rest == 65488
    # 480 packed weights and their bin-filter words, the offsets of 23
    # filters, a warp's 32 lane partials and 23 filter sums
    assert frontend.smem_bytes(T_CONFIGS["kaldi_plp"]) == 4 * (rest + 2 * 480 + 24 + 56 * 8)
    # mel and melf packed (459 weights each) and their words, 26 filters,
    # both scratches
    assert frontend.smem_bytes(cfg) == 4 * (rest + 3 * 460 + 28 + 116 * 8)
    assert frontend.feature_kind(T_CONFIGS["classic13"]) == "logmel"
