"""The port's long-utterance extraction ≡ the JAX package's
(`mfcc_tpu.pipeline.longform`) and ≡ monolithic extraction.

- `segment_plan` and `_host_reflect_extend` equal the JAX package's;
- `extract_long(device="cpu")` (segments of 0.5 s on 3.3 s signals) is held
  to the JAX package's `extract_long(backend="jnp")` and to the port's
  monolithic `chain.extract_single`, for classic13_deltas, kaldi_mfcc
  centered, mfcc39_48k, whisper80, utterance CMVN, kaldi_plp and logmel80,
  at each family's gate (lifted cepstra 5e-4; resampled 8e-4; Kaldi mfcc
  5e-4; PLP; whisper80 5e-5; log-mel two-regime);
- the kernel-path stitch: the prefix of each segment stitched and finished
  by `tail.feature_tail` (its plain version here) equals the torch post-pass
  over the stitched base features;
- dither raises; one segment takes `extract_single`; `long_moments`.
"""

import numpy as np
import pytest
import torch

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.pipeline import extract_long as jextract_long
from mfcc_tpu.pipeline import longform as jlongform
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.pipeline import extract_long, long_moments
from mfcc_tpu_torch.pipeline import longform
from mfcc_tpu_torch.testing import (
    RESAMPLED_FEATURE_ATOL, assert_family_features_close, assert_features_close,
    assert_kaldi_features_close, assert_logmel_close, assert_whisper_features_close,
)

SEG_S = 0.5
CASES = [
    ("classic13_deltas", {}),
    ("kaldi_mfcc", {"frame_tail": "center"}),
    ("mfcc39_48k", {}),
    ("whisper80", {}),
    ("classic13_deltas", {"cmvn": "utterance"}),
    ("kaldi_plp", {}),
    ("logmel80", {}),
]


def _signal(cfg, seconds: float = 3.3, seed: int = 0) -> np.ndarray:
    sr = cfg.input_sample_rate or cfg.sample_rate
    g = np.random.default_rng(seed)
    return (g.standard_normal(int(seconds * sr)) * 3000).astype(np.float32)


def _assert_close(cfg, got, want):
    if cfg.logmel_norm == "whisper":
        assert_whisper_features_close(got, want)
    elif cfg.features == "logmel":
        assert_logmel_close(got, want, cfg.log_kind)
    elif cfg.features != "mfcc":
        assert_family_features_close(got, want, cfg.features)
    elif chain.resamples(cfg):
        np.testing.assert_allclose(got, want, atol=RESAMPLED_FEATURE_ATOL, rtol=2e-5)
    elif cfg.remove_dc_offset:  # the Kaldi family
        assert_kaldi_features_close(got, want, cfg)
    else:
        assert_features_close(got, want)


@pytest.mark.parametrize("name,over", CASES, ids=[f"{n}{'-' + '-'.join(o) if o else ''}" for n, o in CASES])
def test_extract_long_matches_reference_and_monolithic(name, over):
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    x = _signal(tcfg)
    got = extract_long(x, tcfg, device="cpu", seg_len_s=SEG_S)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(jextract_long(x, jcfg, backend="jnp", seg_len_s=SEG_S))
    assert got.shape == want.shape
    _assert_close(tcfg, got.numpy(), want)
    mono = chain.extract_single(torch.as_tensor(x), tcfg, device="cpu").numpy()
    _assert_close(tcfg, got.numpy(), mono)


@pytest.mark.parametrize("n", [0, 399, 400, 401, 16000, 33333])
@pytest.mark.parametrize("name", ["classic13", "kaldi_mfcc", "whisper80"])
def test_segment_plan_and_reflect_extension_match_reference(n, name):
    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    for seg in (1, 7, 100):
        got, f_got = longform.segment_plan(n, tcfg, seg)
        want, f_want = jlongform.segment_plan(n, jcfg, seg)
        assert f_got == f_want
        assert [tuple(vars(s).values()) for s in got] == [tuple(vars(s).values()) for s in want]
    for tail in ("center", "center_reflect"):
        x = _signal(tcfg, seconds=n / 16000 + 1e-9, seed=n)[:n]
        ext, c = longform._host_reflect_extend(x, tcfg.replace(frame_tail=tail))
        jext, jc = jlongform._host_reflect_extend(x, jcfg.replace(frame_tail=tail))
        np.testing.assert_array_equal(ext, jext)
        assert c.config_hash() == jc.config_hash()
    with pytest.raises(ValueError):
        longform.segment_plan(n, tcfg, 0)


@pytest.mark.parametrize("over", [{}, {"cmvn": "utterance"}, {"cmvn": "utterance", "cmvn_var_norm": False},
                                  {"deltas": 1}, {"append_energy": False}], ids=str)
def test_prefix_stitch_equals_the_torch_post_pass(over):
    """The kernel-path design on the CPU: segment prefixes stitched into one
    [1, F_total, n_mels+1] prefix, finished by the feature tail's plain
    version, equal the stitched base features run through `_post_pass`."""
    cfg = T_CONFIGS["classic13_deltas"].replace(**over)
    x = torch.as_tensor(_signal(cfg, seconds=2.2, seed=4))
    got = extract_long(x, cfg, device="cpu", seg_len_s=SEG_S)
    S, L = cfg.frame_step, cfg.frame_length
    seg_frames = int(SEG_S * cfg.sample_rate) // S
    segs, F_total = longform.segment_plan(x.shape[0], cfg, seg_frames)
    cfg_base = cfg.replace(deltas=0, cmvn="off")
    base = []
    for s in segs:  # one segment a batch: the batch composition changes nothing
        row = x[s.offset : s.offset + s.row_len]
        feat, _ = chain.extract_batch(row[None], [s.row_len], cfg_base, device="cpu")
        base.append(feat[0, s.halo : s.halo + s.keep])
    want = longform._post_pass(torch.cat(base), cfg)
    assert got.shape == want.shape == (F_total, cfg.feat_dim)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


def test_dither_raises_and_short_input_takes_extract_single():
    cfg = T_CONFIGS["kaldi_mfcc"].replace(dither=1.0)
    x = _signal(cfg, seconds=1.3)
    with pytest.raises(ValueError, match="dither"):
        extract_long(x, cfg, device="cpu", seg_len_s=SEG_S)
    cfg = T_CONFIGS["classic13_deltas"]
    x = _signal(cfg, seconds=0.4)
    assert torch.equal(extract_long(x, cfg, device="cpu", seg_len_s=SEG_S),
                       chain.extract_single(x, cfg, device="cpu"))
    pcm = np.round(_signal(cfg, seconds=1.7)).astype(np.int16)
    assert torch.equal(extract_long(pcm, cfg, device="cpu", seg_len_s=SEG_S),
                       extract_long(pcm.astype(np.float32), cfg, device="cpu", seg_len_s=SEG_S))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_long(x, cfg, seg_len_s=SEG_S)


def test_long_moments_match_reference():
    feat = np.random.default_rng(2).standard_normal((57, 39)).astype(np.float32)
    for f in (feat, torch.as_tensor(feat)):
        got = long_moments(f)
        want = jlongform.long_moments(feat)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_whisper80_fed_48k_over_60_s_matches_reference():
    """whisper80 fed 48 kHz (centered framing of resampled rows, which the
    port refused before) over 60 s: `mfcc_tpu_torch.extract` takes
    `extract_long` (resample first, then segments of the 16 kHz signal)
    and matches the JAX package's `extract` of the same samples, frame for
    frame, within whisper80's gate (5e-5), and the port's monolithic
    `extract_single`."""
    import mfcc_tpu
    import mfcc_tpu_torch

    tcfg = T_CONFIGS["whisper80"].replace(input_sample_rate=48000)
    jcfg = J_CONFIGS["whisper80"].replace(input_sample_rate=48000)
    x = _signal(tcfg, seconds=75.0, seed=3)
    got = mfcc_tpu_torch.extract(x, tcfg, device="cpu")
    want = np.asarray(mfcc_tpu.extract(x, jcfg))
    assert got.shape == want.shape == (tcfg.num_frames(75 * 16000), tcfg.feat_dim)
    assert_whisper_features_close(got.numpy(), want)
    mono = chain.extract_single(torch.as_tensor(x), tcfg, device="cpu").numpy()
    assert_whisper_features_close(got.numpy(), mono)
