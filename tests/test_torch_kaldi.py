"""The port's Kaldi feature-window path and logmel80 ≡ the JAX package's.

kaldi_mfcc and kaldi_fbank ("drop" framing, dither, frame-first
conditioning, `ln_floor`) and logmel80 (`ln_stab`), plus the `db` log, on
the CPU: the port's plain chain and the front-end's plain version against
the float64 oracle, the jnp chain, the Pallas kernel in interpret mode and
the goldens, on the same numpy inputs. Gates (`mfcc_tpu_torch.testing`):
  - float64 vs the oracle: 1e-10 (every convention exact);
  - fp32 Kaldi features: 5e-4 (mfcc) / 1e-4 (fbank) on well-conditioned
    signals, rtol 1e-5 (docs/ACCURACY.md finding 5);
  - log-mel features (logmel80, kaldi_fbank goldens): two-regime, 1e-4 on
    bins within 40 dB of the row max, 1e-5 of the row max in the linear
    domain;
  - the [log-mel | energy] prefix against the Pallas kernel: the
    kernel-vs-twin gates, with each log kind taken to natural log first;
  - dithered features vs the jnp chain: 5e-4 (the noise differs only by
    ulps of ln/sqrt); batch positions, int16 ≡ float32 and dirty tails:
    bitwise.
"""

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
from mfcc_tpu.ops import reference_numpy as ref
from mfcc_tpu.testing.golden import golden_signals, load_golden
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain
from mfcc_tpu_torch.pipeline import batch as tbatch

# the non-centered variants of tests/test_kaldi_conventions.py::KALDI_VARIANTS
KALDI_VARIANTS = {
    "kaldi_mfcc": {},
    "kaldi_fbank": {},
    "windowed_energy": dict(energy_source="windowed_frame"),
    "energy_floor": dict(energy_floor=1e-3),
    "vtln_low": dict(vtln_warp=0.9),
    "vtln_high": dict(vtln_warp=1.1),
    "deltas": dict(deltas=2),
    "no_dc": dict(remove_dc_offset=False),
    "signal_preemph_kaldi_mel": dict(preemph_mode="signal"),
}
KALDI_LENGTHS = (32000 + 137, 400, 100, 16000)  # 100 < L: no frames


def _configs(name, **extra):
    base = "kaldi_fbank" if name == "kaldi_fbank" else "kaldi_mfcc"
    over = {**KALDI_VARIANTS.get(name, {}), **extra}
    return T_CONFIGS[base].replace(**over), J_CONFIGS[base].replace(**over)


def _two_rows():
    """tests/test_kaldi_conventions.py::test_dither_kernel_equals_twin's batch."""
    g = np.random.default_rng(11)
    x = np.stack([
        g.standard_normal(32000).astype(np.float32) * 300,
        np.concatenate([g.standard_normal(9000).astype(np.float32) * 300,
                        np.zeros(32000 - 9000, np.float32)]),
    ])
    return x, np.array([32000, 9000], np.int32)


@pytest.mark.parametrize("name", sorted(KALDI_VARIANTS))
def test_kaldi_variant_fp64_exact(name):
    tcfg, jcfg = _configs(name, dtype="float64")
    for n in KALDI_LENGTHS:
        x = np.random.default_rng(n).standard_normal(n) * 1000
        want = ref.extract(x, jcfg)
        got = mfcc_tpu_torch.extract(x, tcfg, device="cpu")
        assert got.dtype == torch.float64 and tuple(got.shape) == want.shape, (name, n, got.shape)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=1e-10, err_msg=f"{name} n={n}")


@pytest.mark.parametrize("name", ["kaldi_mfcc", "kaldi_fbank", "logmel80"])
def test_fp32_gate_vs_oracle(name):
    x = (np.random.default_rng(11).standard_normal(32137) * 1000).astype(np.float64)
    want = ref.extract(x, J_CONFIGS[name])
    got = mfcc_tpu_torch.extract(x.astype(np.float32), T_CONFIGS[name], device="cpu")
    if name == "logmel80":
        testing.assert_logmel_close(got, want, "ln_stab")
    else:
        testing.assert_kaldi_features_close(got, want, T_CONFIGS[name])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dither_replay_through_the_oracle(dtype):
    """The chain's own draw ("dither_noise"), replayed through the float64
    oracle: exact in float64, the fp32 gate in float32."""
    tcfg, jcfg = _configs("kaldi_mfcc", dither=1.0, dither_seed=42, dtype=dtype)
    x = np.random.default_rng(11).standard_normal(16000) * 1000
    audio = torch.as_tensor(x[None].astype(dtype))
    lengths = torch.tensor([16000], dtype=torch.int32)
    stages = tchain.logmel_stages(audio, lengths, tcfg)
    feat = tchain.features_from_logmel(stages, tcfg)[0, : tcfg.num_frames(16000)]
    noise = stages["dither_noise"][0].double().numpy()
    want = ref.extract(x, jcfg.replace(dtype="float64"), dither_noise=noise)
    if dtype == "float64":
        np.testing.assert_allclose(feat.numpy(), want, atol=1e-10)
    else:
        testing.assert_kaldi_features_close(feat, want, tcfg)
    # the oracle's own draw (the numpy twin) differs only by ln/sqrt ulps
    np.testing.assert_allclose(feat.double().numpy(), ref.extract(x, jcfg.replace(dtype="float64")),
                               atol=1e-6 if dtype == "float64" else 5e-4)


@pytest.mark.parametrize(
    "name,over",
    [("kaldi_mfcc", dict(dither=1.0)), ("classic13_deltas", dict(dither=0.5)),
     ("kaldi_fbank", dict(dither=1.0)), ("kaldi_mfcc", dict(energy_source="windowed_frame")),
     ("kaldi_mfcc", dict(input_sample_rate=48000, dither=1.0))],
    ids=["kaldi_mfcc_dither", "classic13_deltas_dither", "kaldi_fbank_dither", "windowed_energy",
         "kaldi_mfcc_48k_dither"],
)
def test_matches_jnp_chain(name, over):
    """Resampled rows take the resampling family's 8e-4 (fp32 resample sums);
    the dither then keys on 16 kHz positions in both packages."""
    x, lens = _two_rows()
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    jf, jm = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="jnp")
    tf, tm = tchain.extract_batch(x, lens, tcfg, device="cpu")
    assert tf.shape == jf.shape
    atol = testing.RESAMPLED_FEATURE_ATOL if tchain.resamples(tcfg) else 5e-4
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=atol, rtol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_dither_batch_position_invariance():
    """The contract has no batch term: one utterance at two rows of a batch
    gets the same bytes on its valid frames."""
    cfg = T_CONFIGS["kaldi_mfcc"].replace(dither=1.0)
    g = np.random.default_rng(4)
    u = np.concatenate([g.standard_normal(12000).astype(np.float32) * 200,
                        np.zeros(4000, np.float32)])
    batch = np.stack([u, g.standard_normal(16000).astype(np.float32), u])
    feat, mask = tchain.extract_batch(batch, [12000, 16000, 12000], cfg, device="cpu")
    nv = int(tchain.num_valid_frames(torch.tensor([12000]), cfg)[0])
    assert nv == cfg.num_frames(12000) and int(mask[0].sum()) == nv
    np.testing.assert_array_equal(feat[0, :nv].numpy(), feat[2, :nv].numpy())
    prefix = frontend.logmel_prefix(torch.as_tensor(batch), torch.tensor([12000, 16000, 12000],
                                                                          dtype=torch.int32), cfg)
    np.testing.assert_array_equal(prefix[0, :nv].numpy(), prefix[2, :nv].numpy())


GOLDEN_CASES = [(c, s) for c in ("kaldi_mfcc", "kaldi_fbank") for s in ("noise", "speechish", "short")]
GOLDEN_CASES += [("logmel80", s) for s in sorted(golden_signals())]


@pytest.mark.parametrize("config_name,signal_name", GOLDEN_CASES)
def test_golden_parity(config_name, signal_name):
    g = load_golden(config_name, signal_name)
    cfg = T_CONFIGS[config_name]
    feat = mfcc_tpu_torch.extract(g["signal"], cfg, device="cpu")
    assert tuple(feat.shape) == g["features"].shape
    if g["features"].shape[0] == 0:  # shorter than a frame under "drop" framing
        return
    if config_name == "logmel80":
        testing.assert_logmel_close(feat, g["features"], cfg.log_kind)
    else:
        testing.assert_kaldi_features_close(feat, g["features"], cfg)


def _golden_batch(names=("noise", "speechish", "short", "tone_offbin")):
    sigs = golden_signals()
    chosen = [sigs[n] for n in names]
    b = jpipeline.pad_batch(chosen, J_CONFIGS["kaldi_mfcc"], bucket_len=max(s.shape[0] for s in chosen))
    return b.audio, b.lengths


@pytest.mark.parametrize(
    "name,over",
    [("kaldi_mfcc", dict(dither=1.0)), ("kaldi_fbank", {}), ("logmel80", {}),
     ("logmel80", dict(log_kind="db"))],
    ids=["kaldi_mfcc_dither", "kaldi_fbank", "logmel80", "logmel80_db"],
)
def test_reference_matches_pallas_prefix(name, over):
    """The kernel's plain version ≡ the Pallas kernel (interpret mode), on
    [log-mel | energy], each log kind taken to natural log."""
    audio, lengths = _golden_batch()
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    F = tcfg.num_frames(audio.shape[1])
    fused = fused_logmel_stages(jnp.asarray(audio), jnp.asarray(lengths), jcfg, interpret=True)
    want = np.asarray(fused["prefix_fp"])[:, :F]
    got = frontend.logmel_prefix_reference(torch.as_tensor(audio), torch.as_tensor(lengths), tcfg)
    assert tuple(got.shape) == (4, F, tcfg.n_mels + 1)
    valid = lengths > 0
    testing.assert_prefix_close(got.numpy()[valid], want[valid], tcfg.n_mels, tcfg.log_kind)


def test_prefix_gate_reads_db_lanes_as_natural_log():
    """A db lane differs from ln by 10/ln 10, a log10_floor lane by 1/ln 10;
    the gates convert them first, so the same relative error reads the same
    under every kind, and an unknown kind raises."""
    g = np.random.default_rng(2)
    lin = np.exp(g.uniform(0, 20, size=(3, 5, 4)))
    want = np.concatenate([np.log(lin), lin.sum(-1, keepdims=True)], -1)
    got = want.copy()
    got[..., :4] += 8e-6  # inside the 2e-5 loud and 1e-5 linear gates
    testing.assert_prefix_close(got, want, 4)
    db = want.copy()
    db[..., :4] = 10 * np.log10(lin)
    db_got = db.copy()
    db_got[..., :4] += 8e-6 * 10 / np.log(10)
    testing.assert_prefix_close(db_got, db, 4, "db")
    with pytest.raises(AssertionError, match="logmel_loud_max_abs"):
        testing.assert_prefix_close(db_got, db, 4)  # read as ln: 4.3x the error, over the gate
    lg = want.copy()
    lg[..., :4] = np.log10(lin)
    lg_got = lg.copy()
    lg_got[..., :4] += 8e-6 / np.log(10)
    testing.assert_prefix_close(lg_got, lg, 4, "log10_floor")
    with pytest.raises(ValueError, match="log_kind='log2'"):
        testing.prefix_errors(got, want, 4, "log2")


def test_log_kinds_match_jax():
    x = np.array([[0.0, 1e-9, 1.1920929e-07, 1e-3, 1.0, 12345.0]], np.float32)
    for kind in tchain.LOG_KINDS:
        tcfg = T_CONFIGS["classic13"].replace(log_kind=kind)
        jcfg = J_CONFIGS["classic13"].replace(log_kind=kind)
        got = tchain.apply_log(torch.as_tensor(x), tcfg).numpy()
        np.testing.assert_allclose(got, np.asarray(jchain.apply_log(jnp.asarray(x), jcfg)), rtol=1e-6)
    assert tuple(tchain.LOG_KINDS) == ("ln", "ln_stab", "db", "ln_floor", "log10_floor")


def test_preemphasis_frames_matches_jax():
    frames = np.random.default_rng(3).standard_normal((2, 3, 7)).astype(np.float32)
    for c in (0.0, 0.97):
        got = tchain.preemphasis_frames(torch.as_tensor(frames), c).numpy()
        np.testing.assert_allclose(got, np.asarray(jchain.preemphasis_frames(jnp.asarray(frames), c)),
                                   rtol=1e-6, atol=1e-7)


def test_num_valid_frames_drop_matches_jax():
    lens = [0, 1, 399, 400, 401, 559, 560, 561, 16000, 40123]
    for name in ("kaldi_mfcc", "classic13"):
        got = tchain.num_valid_frames(torch.tensor(lens), T_CONFIGS[name]).numpy()
        want = np.asarray(jchain.num_valid_frames(jnp.asarray(lens), J_CONFIGS[name]))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,over", [("kaldi_mfcc", dict(dither=1.0)), ("kaldi_fbank", {}),
                                       ("logmel80", dict(dither=0.5))])
def test_int16_rows_and_dirty_tails_bitwise(name, over):
    cfg = T_CONFIGS[name].replace(**over)
    g = np.random.default_rng(5)
    pcm = (g.standard_normal((3, 9000)) * 3000).astype(np.int16)
    lengths = torch.tensor([9000, 5000, 399], dtype=torch.int32)
    clean = pcm.copy()
    clean[1, 5000:] = 0
    clean[2, 399:] = 0
    got = frontend.logmel_prefix(torch.as_tensor(pcm), lengths, cfg)
    assert torch.equal(got, frontend.logmel_prefix(torch.as_tensor(clean), lengths, cfg))
    assert torch.equal(got, frontend.logmel_prefix(torch.as_tensor(clean.astype(np.float32)), lengths, cfg))


def test_short_batch_gives_no_frames():
    """Under "drop" framing a batch shorter than a frame has F = 0: an empty
    prefix and empty features, not an error."""
    cfg = T_CONFIGS["kaldi_mfcc"].replace(dither=1.0)
    audio = torch.zeros((2, 300), dtype=torch.int16)
    lengths = torch.tensor([300, 12], dtype=torch.int32)
    assert tuple(frontend.logmel_prefix(audio, lengths, cfg).shape) == (2, 0, cfg.n_mels + 1)
    feat, mask = tchain.extract_batch(audio, lengths, cfg, device="cpu")
    assert tuple(feat.shape) == (2, 0, cfg.feat_dim) and tuple(mask.shape) == (2, 0)


@pytest.mark.parametrize("name", ["kaldi_mfcc", "kaldi_fbank"])
def test_pad_batch_under_drop_matches_jax(name):
    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    for n in (0, 100, 399, 400, 401, 16000, 16001):
        assert tbatch.required_samples(n, tcfg) == jpipeline.required_samples(n, jcfg)
    utts = [np.arange(n) % 300 - 150 for n in (100, 400, 16001, 5000)]
    want = jpipeline.pad_batch(utts, jcfg, pad_batch_to=6)
    got = tbatch.pad_batch(utts, tcfg, pad_batch_to=6)
    assert got.audio.dtype == want.audio.dtype
    np.testing.assert_array_equal(got.audio, want.audio)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    short = tbatch.pad_batch([np.ones(100)], tcfg)
    np.testing.assert_array_equal(short.audio, jpipeline.pad_batch([np.ones(100)], jcfg).audio)


@pytest.mark.parametrize(
    "over",
    [dict(win_len_s=3.0),
     dict(frame_tail="center", input_sample_rate=48000),
     dict(log_kind="log10_floor", n_fft=16384),
     dict(drop_last_frame=True, frame_tail="center_reflect", input_sample_rate=44100),
     dict(log_kind="log10_floor", n_fft=4096)],
    ids=["long_frame_conditioning", "centered", "log10_floor", "drop_last_frame", "log10_floor_4096"],
)
def test_outside_the_slice_raises_on_cpu(over):
    """Conditioning of long frames, centered framing, log10_floor and
    drop_last_frame are in the port, and what raised beside them before now
    runs: centered framing of resampled rows (48 and 44.1 kHz), n_fft 4096
    (the block FFT plan), 3 s frames (the gather plan: the conditioning's
    sums over all 48,000 samples) and n_fft 16384 (the packed bands read
    from device memory): two ragged rows (of a frame and more) against the
    JAX package's jnp chain at the resampled features' gate, masks equal."""
    cfg = T_CONFIGS["kaldi_mfcc"].replace(**over)
    jcfg = J_CONFIGS["kaldi_mfcc"].replace(**over)
    g = np.random.default_rng(5)
    sr = cfg.input_sample_rate or cfg.sample_rate
    k = -(-2 * cfg.frame_length // cfg.sample_rate)  # seconds: rows of two frames or more
    utts = [np.round(g.standard_normal(n) * 3000) for n in (k * sr, k * sr // 2 + 77)]
    b = jpipeline.pad_batch(utts, jcfg)
    feat, mask = tchain.extract_batch(b.audio.astype(np.int16), b.lengths, cfg, device="cpu")
    assert mask.sum() > 1
    jfeat, jmask = jchain.extract_batch(jnp.asarray(b.audio), jnp.asarray(b.lengths), jcfg, backend="jnp")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=testing.RESAMPLED_FEATURE_ATOL,
                               rtol=testing.RESAMPLED_FEATURE_RTOL)


def test_dither_float64_chain_is_exact_under_x64():
    """The port's float64 chain with dither ≡ the JAX jnp chain under x64
    fed the same noise: every convention exact."""
    tcfg, jcfg = _configs("kaldi_mfcc", dither=1.0, dtype="float64")
    x, lens = _two_rows()
    x = x.astype(np.float64)
    st = tchain.logmel_stages(torch.as_tensor(x), torch.as_tensor(lens), tcfg)
    got = tchain.features_from_logmel(st, tcfg).numpy()
    noise = st["dither_noise"][0].numpy()
    for i, n in enumerate(lens):
        want = ref.extract(x[i, :n], jcfg, dither_noise=noise[:n])
        np.testing.assert_allclose(got[i, : len(want)], want, atol=1e-10)
    with jax.enable_x64(True):
        jst = jchain.logmel_stages(jnp.asarray(x), jnp.asarray(lens), jcfg)
        np.testing.assert_allclose(np.asarray(jst["dither_noise"]), st["dither_noise"].numpy(),
                                   rtol=0, atol=1e-6)
