"""The port's streaming (`mfcc_tpu_torch.pipeline.StreamingExtractor`,
`stream_features`, `ops.resample.StreamingResampler`) ≡ the JAX package's
`mfcc_tpu.pipeline.streaming`, on the CPU (the kernels' plain versions).

- `StreamingResampler` ≡ the reference's bitwise and ≡ scipy `resample_poly`
  within 1e-12 in float64, for any chunking;
- every streamable named config streamed at K = 16 against the JAX
  package's `StreamingExtractor` on the same chunks and against the port's
  offline `chain.extract_batch(device="cpu")`, at the family's gate
  (lifted cepstra 5e-4; resampled 8e-4; Kaldi; log-mel two-regime; PLP,
  spectrogram and SSC gates), frame counts equal;
- the chunkings of tests/test_streaming.py (one push, per hop, ragged; K of
  1, 3, 16, 32 and 128; streams shorter than a frame; K under the
  lookahead; the empty stream) against the offline chain;
- the block launch's plain version against the reference's
  `_make_base_block` (its base features), with a zero and a dirty
  pre-context and valid at the edges;
- one block launch a round, and the refusals word for word;
- a fault of the reference the port does not copy: a resampled stream whose
  flush holds a whole block in the resampler's tail overflows the
  reference's finalize window (AssertionError); the port drains it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops.resample import StreamingResampler as JResampler
from mfcc_tpu.pipeline import streaming as jstreaming
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.ops.resample import StreamingResampler
from mfcc_tpu_torch.pipeline import StreamingExtractor, stream_features
from tests.test_torch_longform import _assert_close

STREAMABLE = ["classic13", "classic13_deltas", "ssc26", "logmel80", "classic13_deltas_gcmvn",
              "mfcc39_48k", "mfcc39_44k", "kaldi_mfcc", "kaldi_spectrogram", "kaldi_fbank",
              "kaldi_plp"]


def _signal(cfg, seconds: float, seed: int) -> np.ndarray:
    sr = cfg.input_sample_rate or cfg.sample_rate
    g = np.random.default_rng(seed)
    return np.round(g.standard_normal(int(seconds * sr)) * 3000).astype(np.float32)


def _chunks(x: np.ndarray, size: int) -> list:
    return [x[i : i + size] for i in range(0, len(x), size)]


def _ragged(n: int, seed: int = 7, hi: int = 1900) -> list:
    sizes, left, r = [], n, np.random.default_rng(seed)
    while left > 0:
        sizes.append(int(min(left, r.integers(1, hi))))
        left -= sizes[-1]
    return sizes


def _run(ex, x, sizes) -> np.ndarray:
    parts, pos = [], 0
    for c in sizes:
        parts.append(ex.push(x[pos : pos + c]))
        pos += c
    assert pos == len(x)
    parts.append(ex.flush())
    return np.concatenate(parts, axis=0)


def _offline(x, cfg) -> np.ndarray:
    cfg = cfg.replace(cmvn="off") if cfg.cmvn == "global" else cfg
    return chain.extract_single(torch.as_tensor(x), cfg, device="cpu").numpy()


def _moments(feat: np.ndarray):
    f = feat.astype(np.float64)
    return f.sum(0), (f**2).sum(0), float(f.shape[0])


@pytest.mark.parametrize("sr_in, sr_out", [(48000, 16000), (44100, 16000), (8000, 16000)])
def test_streaming_resampler_matches_reference_and_scipy(sr_in, sr_out):
    g = np.random.default_rng(sr_in)
    x = g.standard_normal(sr_in // 3 + 17)
    want = scipy.signal.resample_poly(x, *reversed(np.array([sr_in, sr_out]) // np.gcd(sr_in, sr_out)))
    for sizes in ([len(x)], [1] * 50 + [len(x) - 50], _ragged(len(x), seed=sr_out, hi=3000)):
        mine = StreamingResampler(sr_in, sr_out, dtype=np.float64)
        ref = JResampler(sr_in, sr_out, dtype=np.float64)
        got = np.concatenate([mine.push(x[a : a + c]) for a, c in zip(np.cumsum([0] + sizes), sizes)]
                             + [mine.flush()])
        theirs = np.concatenate([ref.push(x[a : a + c]) for a, c in zip(np.cumsum([0] + sizes), sizes)]
                                + [ref.flush()])
        assert np.array_equal(got, theirs)
        assert got.shape == want.shape and np.abs(got - want).max() < 1e-12
        assert mine.samples_out == len(want)
    r = StreamingResampler(sr_in, sr_out)
    r.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        r.push(x[:10])
    with pytest.raises(ValueError, match="nothing to resample"):
        StreamingResampler(16000, 16000)


@pytest.mark.parametrize("name", STREAMABLE)
def test_stream_matches_reference_and_offline(name):
    """Every streamable named config at K = 16 (1.3 s, ragged chunks; the
    resampled configs on tests/test_streaming.py's lengths and chunks,
    48,000·2 + 731 samples in 1,337s and 44,100 + 977 in 997s, which the
    reference completes): within the family's gate of the JAX package's
    streaming and of the port's offline chain, frame counts equal."""
    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    seconds = {"mfcc39_48k": (48000 * 2 + 731) / 48000, "mfcc39_44k": (44100 + 977) / 44100}
    x = _signal(tcfg, seconds.get(name, 1.3), seed=len(name))
    sizes = ({"mfcc39_48k": [1337] * (len(x) // 1337) + [len(x) % 1337],
              "mfcc39_44k": [997] * (len(x) // 997) + [len(x) % 997]}.get(name) or _ragged(len(x)))
    moments = _moments(_offline(x, tcfg)) if tcfg.cmvn == "global" else None
    got = _run(StreamingExtractor(tcfg, frames_per_block=16, cmvn_moments=moments, device="cpu"),
               x, sizes)
    want = _run(jstreaming.StreamingExtractor(jcfg, frames_per_block=16, cmvn_moments=moments),
                x, sizes)
    off = _offline(x, tcfg)
    assert got.shape == want.shape == (tcfg.num_frames(chain.valid_length(len(x), tcfg)), tcfg.feat_dim)
    _assert_close(tcfg, got, want)
    if moments is None:
        _assert_close(tcfg, got, off)
    else:  # the same moments on the offline features
        mu, var = moments[0] / moments[2], moments[1] / moments[2] - (moments[0] / moments[2]) ** 2
        norm = (off - mu.astype(np.float32)) / np.sqrt(var.astype(np.float32) + np.float32(tcfg.cmvn_eps))
        np.testing.assert_allclose(got, norm, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["classic13", "classic13_deltas", "logmel80"])
@pytest.mark.parametrize("how", ["one_push", "per_hop", "ragged"])
def test_stream_parity_for_any_chunking(name, how):
    cfg = T_CONFIGS[name]
    n = 16000 + 373  # an odd tail: a partial final frame
    x = _signal(cfg, n / 16000, seed=42)
    sizes = {"one_push": [n], "per_hop": [160] * (n // 160) + [n % 160], "ragged": _ragged(n)}[how]
    got = _run(StreamingExtractor(cfg, frames_per_block=32, device="cpu"), x, sizes)
    want = _offline(x, cfg)
    assert got.shape == want.shape
    _assert_close(cfg, got, want)


@pytest.mark.parametrize("K", [1, 3, 128])
def test_stream_block_sizes(K):
    """K = 1 and 3 under the lookahead of 4 frames, 128 on 5 s in 4,096-sample
    pushes."""
    cfg = T_CONFIGS["classic13_deltas"]
    x = _signal(cfg, 5.0 if K == 128 else 1.0, seed=K)
    size = 4096 if K == 128 else 320
    got = _run(StreamingExtractor(cfg, frames_per_block=K, device="cpu"), x,
               [size] * (len(x) // size) + ([len(x) % size] if len(x) % size else []))
    want = _offline(x, cfg)
    assert got.shape == want.shape
    _assert_close(cfg, got, want)


@pytest.mark.parametrize("n", [1, 250, 399, 400, 401, 560, 5359])
@pytest.mark.parametrize("name", ["classic13_deltas", "kaldi_mfcc"])
def test_short_streams(n, name):
    """Shorter than a frame, one frame, a handful; "drop" framing gives none
    under a frame."""
    cfg = T_CONFIGS[name]
    x = _signal(cfg, n / 16000, seed=n)
    got = _run(StreamingExtractor(cfg, frames_per_block=16, device="cpu"), x, [n])
    assert got.shape == (cfg.num_frames(n), cfg.feat_dim)
    if got.shape[0]:
        _assert_close(cfg, got, _offline(x, cfg))


def test_holdback_and_prompt_emission():
    """K = 8: with no deltas a full block's samples emit its 8 frames at
    once; with Δ+ΔΔ the last 4 await their lookahead (the reference's
    rule)."""
    x = _signal(T_CONFIGS["classic13"], 0.2, seed=1)
    ex = StreamingExtractor(T_CONFIGS["classic13"], frames_per_block=8, device="cpu")
    assert ex.push(x[: ex.span]).shape[0] == 8
    ex = StreamingExtractor(T_CONFIGS["classic13_deltas"], frames_per_block=8, device="cpu")
    assert ex.push(x[: ex.span]).shape[0] == 4
    assert ex.frames_emitted == 4 and ex.samples_consumed == ex.span


def test_empty_stream_and_closed_stream():
    cfg = T_CONFIGS["classic13_deltas"]
    ex = StreamingExtractor(cfg, device="cpu")
    assert ex.flush().shape == (0, cfg.feat_dim)
    with pytest.raises(RuntimeError, match="flushed"):
        ex.push(np.zeros(100, np.float32))
    with pytest.raises(RuntimeError, match="flushed"):
        ex.flush()
    with pytest.raises(ValueError, match="frames_per_block"):
        StreamingExtractor(cfg, frames_per_block=0, device="cpu")


def test_stream_features_generator():
    cfg = T_CONFIGS["classic13_deltas"]
    x = _signal(cfg, 1.0, seed=3)
    got = np.concatenate(list(stream_features(_chunks(x, 777), cfg, frames_per_block=32,
                                              device="cpu")))
    _assert_close(cfg, got, _offline(x, cfg))


@pytest.mark.parametrize(
    "over",
    [{"cmvn": "utterance"}, {"cmvn": "global"}, {"cmvn": "speaker"}, {"frame_tail": "center"},
     {"frame_tail": "center_reflect"}, {"drop_last_frame": True}, {"dither": 1.0},
     {"features": "logmel", "logmel_norm": "whisper"}],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()),
)
def test_refusals_are_the_references_word_for_word(over):
    tcfg, jcfg = T_CONFIGS["classic13"].replace(**over), J_CONFIGS["classic13"].replace(**over)
    with pytest.raises(ValueError) as mine:
        StreamingExtractor(tcfg, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jstreaming.StreamingExtractor(jcfg)
    assert str(mine.value) == str(theirs.value)


def test_whisper80_is_refused():
    with pytest.raises(ValueError, match="centered framing"):
        StreamingExtractor(T_CONFIGS["whisper80"], device="cpu")


@pytest.mark.parametrize("name,over", [("whisper80", {"input_sample_rate": 48000}),
                                       ("classic13", {"frame_tail": "center", "input_sample_rate": 44100})],
                         ids=["whisper80_48k", "classic13_center_44k"])
def test_centered_resampled_rows_are_refused_in_the_references_words(name, over):
    """Offline, centered framing of resampled rows runs (the split route);
    streaming still refuses centered framing, with the reference's message
    word for word, on every device."""
    tcfg, jcfg = T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)
    with pytest.raises(ValueError) as mine:
        StreamingExtractor(tcfg, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jstreaming.StreamingExtractor(jcfg)
    assert str(mine.value) == str(theirs.value) and "centered framing" in str(mine.value)


def test_default_device_is_the_card(monkeypatch):
    """device="cuda" is the default, and without a card it raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingExtractor(T_CONFIGS["classic13_deltas"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(stream_features([np.zeros(10, np.float32)], T_CONFIGS["classic13_deltas"]))


def test_unsupported_config_raises_on_the_card(monkeypatch):
    """What the card still refuses, a float64 config, raises
    NotImplementedError before any launch; 60,000 filters, refused before
    (over the packed mel table's filter field), are taken (the wide plan:
    the projection filter by filter over a tile of frames; without it the
    projection's sums in device memory); n_fft 16384 with 0.9 s frames, refused before,
    is taken (the cluster plan, each frame's FFT rows over a thread-block
    cluster; without it the packed bands read from device memory), and its
    stream on the CPU ≡ the offline chain."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    before = (frontend.launches, frontend.block_launches)
    with pytest.raises(NotImplementedError, match="float32, not float64"):
        StreamingExtractor(T_CONFIGS["classic13"].replace(dtype="float64"))
    many = T_CONFIGS["classic13"].replace(n_mels=60000)
    assert chain.unsupported_reason(many) is None and frontend.fft_plan(many) == "wide"
    assert frontend.fft_layout(many, wide=False)[0] == "gather_sums"
    cfg = T_CONFIGS["classic13"].replace(n_fft=16384, win_len_s=0.9)
    assert chain.unsupported_reason(cfg) is None and frontend.fft_plan(cfg) == "cluster"
    assert frontend.fft_layout(cfg, cluster=False)[0] == "gather_bands"
    assert (frontend.launches, frontend.block_launches) == before
    x = np.round(np.random.default_rng(16384).standard_normal(40000) * 3000).astype(np.float32)
    ex = StreamingExtractor(cfg, frames_per_block=8, device="cpu")
    got = np.concatenate([ex.push(x[:17000]), ex.push(x[17000:]), ex.flush()], axis=0)
    want = chain.extract_single(torch.as_tensor(x), cfg, device="cpu").numpy()
    assert got.shape == want.shape
    _assert_close(cfg, got, want)


@pytest.mark.parametrize("name", ["classic13_deltas", "kaldi_mfcc", "kaldi_plp", "ssc26",
                                  "kaldi_spectrogram", "logmel80"])
def test_block_plain_version_matches_reference_base_block(name):
    """`frontend.logmel_block_reference` (then `chain.base_from_prefix`) ≡
    the reference's `_make_base_block` on the same (span+1)-sample windows:
    a zero and a dirty pre-context, valid at 0, 1, L - 1, L, L + 1 and
    span."""
    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    K, L = 16, tcfg.frame_length
    blk, span = jstreaming._make_base_block(jcfg, K)
    g = np.random.default_rng(11)
    rows = np.round(g.standard_normal((12, span + 1)) * 3000).astype(np.float32)
    rows[:6, 0] = 0.0
    valid = np.array([0, 1, L - 1, L, L + 1, span] * 2, np.int32)
    prefix = frontend.logmel_block_reference(torch.as_tensor(rows), torch.as_tensor(valid), tcfg)
    assert prefix.shape == (12, K, tcfg.n_mels + 1)
    got = chain.base_from_prefix(prefix, None, tcfg).numpy()
    want = np.stack([np.asarray(blk(jnp.asarray(r), jnp.int32(v))) for r, v in zip(rows, valid)])
    assert got.shape == want.shape
    _assert_close(tcfg.replace(deltas=0), got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))
    # the wrapper takes the plain version on the CPU, and refuses what the kernel lacks
    assert torch.equal(frontend.logmel_block(torch.as_tensor(rows), torch.as_tensor(valid), tcfg), prefix)
    with pytest.raises(ValueError, match="block rows"):
        frontend.logmel_block(torch.as_tensor(rows[:, 1:]), torch.as_tensor(valid), tcfg)
    with pytest.raises(ValueError, match="no dither"):
        frontend.logmel_block(torch.as_tensor(rows), torch.as_tensor(valid), tcfg.replace(dither=1.0))


def test_one_block_launch_a_round(monkeypatch):
    """Each device round of a stream launches the front-end's block form
    once, on its one row, and the tail at most twice."""
    from mfcc_tpu_torch.kernels import tail

    calls = []
    real_block, real_tail = frontend.logmel_block, tail.feature_tail
    monkeypatch.setattr(frontend, "logmel_block",
                        lambda rows, valid, cfg, consts=None: calls.append(("block", rows.shape[0]))
                        or real_block(rows, valid, cfg, consts))
    monkeypatch.setattr(tail, "feature_tail",
                        lambda p, n, cfg, consts=None, out=None: calls.append(("tail", p.shape[:2]))
                        or real_tail(p, n, cfg, consts, out=out))
    cfg = T_CONFIGS["classic13_deltas"]
    ex = StreamingExtractor(cfg, frames_per_block=16, device="cpu")
    x = _signal(cfg, 0.5, seed=2)
    real_round, rounds = ex._engine.round, []

    def counted(entries):
        before = len(calls)
        res = real_round(entries)
        rounds.append(calls[before:])
        return res

    monkeypatch.setattr(ex._engine, "round", counted)
    _run(ex, x, [len(x)])
    assert all(sum(c[0] == "block" for c in r) <= 1 and sum(c[0] == "tail" for c in r) <= 2
               for r in rounds)
    assert all(c == ("block", 1) for r in rounds for c in r if c[0] == "block")
    assert {c[1] for r in rounds for c in r if c[0] == "tail"} == {(1, 20), (1, 24)}  # first, inner
    assert sum(c[0] == "block" for r in rounds for c in r) == -(-cfg.num_frames(len(x)) // 16)


@pytest.mark.parametrize("name, chunk", [("mfcc39_48k", 1777), ("mfcc39_44k", 1777)])
def test_resampled_flush_with_a_block_in_the_resampler_tail(name, chunk):
    """The reference's flush computes every pad block before its one drain,
    so when the resampler's look-ahead tail completes a block the window
    overflows (`mfcc_tpu/pipeline/streaming.py:441`, AssertionError); the
    port drains after every block and matches the offline chain."""
    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    x = _signal(tcfg, 1.3, seed=0)
    sizes = [chunk] * (len(x) // chunk) + [len(x) % chunk]
    with pytest.raises(AssertionError, match="finalize window overflow"):
        _run(jstreaming.StreamingExtractor(jcfg, frames_per_block=16), x, sizes)
    got = _run(StreamingExtractor(tcfg, frames_per_block=16, device="cpu"), x, sizes)
    want = _offline(x, tcfg)
    assert got.shape == want.shape
    _assert_close(tcfg, got, want)
