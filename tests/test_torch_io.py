"""The port's io layer ≡ the JAX package's (`mfcc_tpu.io`).

- wav: both of the port's decoders (C++ and numpy) give bitwise the JAX
  package's samples (its numpy decoder, which its own tests hold to its C++
  one) for PCM 8/16/24/32, float32/64, stereo (both downmixes), extensible
  headers and demo.wav, into float32 and int16 rows too; errors raise
  WavError; two processes building the decoder at once both load it.
- feed: `stream_batches` and `stream_batches_direct` (f32 and i16 rows) give
  the JAX package's batches (`layouts="resample"`, a config that does not
  resample): the same audio bytes, lengths, ids and order, with truncate and
  defer, decode errors, wrong rates and `skip_ids`; `RowPool` refills a
  buffer only after the events of the copies that read it have completed.
- writers: HTK and ark bytes, and every npz member's bytes, equal the JAX
  package's writers' for the same features (the spectrogram's HTK USER kind
  included); markers and resume work in both directions.
- cmvn: the accumulators and `apply_cmvn` equal the JAX package's in
  float64; each package loads the other's moments file.
"""

import json
import os
import pathlib
import struct
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from mfcc_tpu import io as jio
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.io import htk as jhtk
from mfcc_tpu.io import kaldi as jkaldi
from mfcc_tpu.parallel import cmvn as jcmvn
from mfcc_tpu_torch import io as tio
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.io import htk as thtk
from mfcc_tpu_torch.io import kaldi as tkaldi
from mfcc_tpu_torch.io import wav as twav
from mfcc_tpu_torch.parallel import cmvn as tcmvn
from mfcc_tpu_torch.pipeline import RowPool

REPO = pathlib.Path(__file__).resolve().parents[1]


def _wav_bytes(body: bytes, tag: int, channels: int, bits: int, sr: int = 16000,
               extensible: bool = False) -> bytes:
    block = channels * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHH", 0xFFFE, channels, sr, sr * block, block, bits)
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", tag) + b"\0" * 14
    else:
        fmt = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    chunks += b"LIST" + struct.pack("<I", 3) + b"abc\0"  # an odd chunk, padded
    chunks += b"data" + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _sample_wavs() -> dict[str, bytes]:
    g = np.random.default_rng(5)
    n = 777
    pcm24 = (g.integers(-2**23, 2**23, n)).astype(np.int64)
    return {
        "pcm8": _wav_bytes(g.integers(0, 256, n).astype("u1").tobytes(), 1, 1, 8),
        "pcm16": _wav_bytes((g.standard_normal(n) * 8000).astype("<i2").tobytes(), 1, 1, 16),
        "pcm24": _wav_bytes(b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in pcm24),
                            1, 1, 24, sr=44100),
        "pcm32": _wav_bytes((g.standard_normal(n) * 2**28).astype("<i4").tobytes(), 1, 1, 32),
        "float32": _wav_bytes((g.standard_normal(n) * 0.5).astype("<f4").tobytes(), 3, 1, 32),
        "float64": _wav_bytes((g.standard_normal(n) * 0.5).astype("<f8").tobytes(), 3, 1, 64),
        "stereo16": _wav_bytes((g.standard_normal(2 * n) * 8000).astype("<i2").tobytes(), 1, 2, 16),
        "stereo_float": _wav_bytes((g.standard_normal(3 * n) * 0.3).astype("<f4").tobytes(), 3, 3, 32),
        "extensible16": _wav_bytes((g.standard_normal(n) * 8000).astype("<i2").tobytes(), 1, 1, 16,
                                   extensible=True),
        "extensible_float": _wav_bytes((g.standard_normal(2 * n) * 0.5).astype("<f4").tobytes(), 3, 2,
                                       32, sr=48000, extensible=True),
    }


WAVS = _sample_wavs()


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("name", sorted(WAVS))
def test_decode_matches_reference(name, native):
    data = WAVS[name]
    for downmix in ("first", "mean"):
        sr, want = jio.decode_wav_bytes(data, downmix=downmix, native=False)
        got_sr, got = twav.decode_wav_bytes(data, downmix=downmix, native=native)
        assert got_sr == sr and got.dtype == np.float32
        if native and downmix == "mean" and name == "stereo_float":
            # three float channels: C's and numpy's mean round apart by an
            # ulp, as in the JAX package (tests/test_io.py holds its two
            # decoders to rtol 1e-5 there); the C source is the same
            np.testing.assert_allclose(got, want, rtol=1e-6)
            continue
        np.testing.assert_array_equal(got, want)
        for dtype in (np.float32, np.int16):
            for cap in (want.shape[0] + 50, want.shape[0] // 2):
                row_t, row_j = np.full(cap, 7, dtype), np.full(cap, 7, dtype)
                assert twav.decode_wav_into(data, row_t, downmix, native=native) == \
                    jio.decode_wav_into(data, row_j, downmix, native=False)
                np.testing.assert_array_equal(row_t, row_j)
    if native:
        assert twav.parse_wav_header(data) == jio.parse_wav_header(data)
        assert twav.parse_wav_header(data[:90], file_size=len(data)) == (sr, want.shape[0])


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
def test_demo_wav_matches_reference(native, tmp_path):
    demo = REPO / "demo.wav"
    sr, want = jio.read_wav(demo, native=False)
    got_sr, got = twav.read_wav(demo, native=native)
    assert got_sr == sr == 16000
    np.testing.assert_array_equal(got, want)
    assert twav.parse_file_header(demo) == (sr, want.shape[0])
    row = np.empty(want.shape[0] + 10, np.int16)
    assert twav.decode_file_into(demo, row, native=native) == (sr, want.shape[0])
    np.testing.assert_array_equal(row[: want.shape[0]], want.astype(np.int16))
    assert not row[want.shape[0]:].any()
    p = tmp_path / "rt.wav"
    twav.write_wav(p, 8000, want[:1000])
    assert p.read_bytes() == _written_by_reference(tmp_path, want[:1000])


def test_decoder_source_is_the_reference_copy():
    """The port's C++ decoder is the JAX package's, apart from its header
    comment: what the C++ route returns is the JAX package's C++ output."""
    body = lambda p: p.read_text().split("#include", 1)[1]  # noqa: E731
    assert body(REPO / "mfcc_tpu_torch/io/csrc/wavdec.cpp") == body(REPO / "mfcc_tpu/io/csrc/wavdec.cpp")


def _written_by_reference(tmp_path, x) -> bytes:
    p = tmp_path / "rt_ref.wav"
    jio.write_wav(p, 8000, x)
    return p.read_bytes()


@pytest.mark.parametrize("native", [True, False], ids=["cpp", "numpy"])
@pytest.mark.parametrize("data", [
    b"", b"RIFFxxxx", b"NOPE" + b"\0" * 100,
    b"RIFF" + struct.pack("<I", 4) + b"WAVE",
    WAVS["pcm16"][:30],
    _wav_bytes(b"\0" * 8, 2, 1, 16),  # ADPCM tag
    _wav_bytes(b"\0" * 8, 1, 1, 12),  # 12-bit PCM
], ids=["empty", "riff_only", "not_riff", "no_chunks", "truncated_fmt", "bad_tag", "bad_bits"])
def test_decode_errors_raise_wav_error(data, native):
    with pytest.raises(twav.WavError) as got:
        twav.decode_wav_bytes(data, native=native)
    with pytest.raises(jio.WavError) as want:
        jio.decode_wav_bytes(data, native=False)
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


def test_two_processes_build_the_decoder_at_once(tmp_path):
    """Two processes building wavdec into one empty directory at once: each
    renames a whole library into place, and both load and decode."""
    code = (
        "import sys, pathlib\n"
        "from mfcc_tpu_torch.io import wav\n"
        f"wav.BUILD_DIR = pathlib.Path({str(tmp_path / 'build')!r})\n"
        "assert wav._native() is not None\n"
        f"sr, x = wav.read_wav({str(REPO / 'demo.wav')!r}, native=True)\n"
        "print(sr, x.shape[0], float(x.sum()))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    assert len(list((tmp_path / "build").glob("wavdec_*.so"))) == 1
    assert not list((tmp_path / "build").glob("*.tmp"))


# ---------------------------------------------------------------------------
# the feed
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def feed_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("feed")
    g = np.random.default_rng(13)
    paths = []
    for i, n in enumerate([4000, 50000, 175000, 9000, 70000, 3000, 22000, 12000, 400]):
        p = d / f"u{i}.wav"
        tio.write_wav(p, 16000, (g.standard_normal(n) * 1000).astype(np.int16))
        paths.append(str(p))
    bad = d / "bad.wav"
    bad.write_bytes(b"RIFF not a wav")
    paths.insert(3, str(bad))
    wrong = d / "wrong.wav"
    tio.write_wav(wrong, 8000, np.zeros(100, np.int16))
    paths.insert(5, str(wrong))
    empty = d / "empty.wav"
    tio.write_wav(empty, 16000, np.zeros(0, np.int16))
    paths.insert(7, str(empty))
    return paths


def _stats(s) -> tuple:
    return (s.decoded, s.errors, s.wrong_rate, s.truncated, s.long_deferred,
            [str(p) for p in s.long_paths], round(s.audio_seconds, 9))


@pytest.mark.parametrize("feed,dtype", [("arrays", None), ("direct", "f32"), ("direct", "i16")])
@pytest.mark.parametrize("long_mode", ["defer", "truncate"])
def test_feed_matches_reference(feed_corpus, feed, dtype, long_mode):
    jcfg, tcfg = J_CONFIGS["classic13"], T_CONFIGS["classic13"]
    kw = dict(batch_size=3, max_len_s=4.0, n_buckets=3, num_threads=3, long_mode=long_mode)
    sj, st = jio.DecodeStats(), tio.DecodeStats()
    if feed == "arrays":
        want = list(jio.stream_batches(feed_corpus, jcfg, stats=sj, layouts="resample", **kw))
        got = list(tio.stream_batches(feed_corpus, tcfg, stats=st, **kw))
    else:
        want = list(jio.stream_batches_direct(feed_corpus, jcfg, stats=sj, dtype=dtype,
                                              layouts="resample", **kw))
        got = list(tio.stream_batches_direct(feed_corpus, tcfg, stats=st, dtype=dtype, **kw))
    assert len(got) == len(want) > 2
    for bt, bj in zip(got, want):
        assert bt.ids == bj.ids
        assert bt.audio.dtype == bj.audio.dtype and bt.audio.shape == bj.audio.shape
        assert bt.audio.tobytes() == bj.audio.tobytes()
        np.testing.assert_array_equal(bt.lengths, bj.lengths)
        bt.release()
    assert _stats(st) == _stats(sj)
    assert st.errors == 2 and st.wrong_rate == 1
    assert (st.long_deferred, st.truncated) == ((2, 0) if long_mode == "defer" else (0, 2))


def test_direct_feed_skip_ids_and_decode_stream(feed_corpus):
    jcfg, tcfg = J_CONFIGS["classic13"], T_CONFIGS["classic13"]
    skip = frozenset(feed_corpus[:4])
    kw = dict(batch_size=4, max_len_s=4.0, dtype="i16", skip_ids=skip)
    want = list(jio.stream_batches_direct(feed_corpus, jcfg, layouts="resample", **kw))
    got = list(tio.stream_batches_direct(feed_corpus, tcfg, **kw))
    assert [b.ids for b in got] == [b.ids for b in want]
    for bt, bj in zip(got, want):
        np.testing.assert_array_equal(bt.lengths, bj.lengths)
        rows = [i for i, u in enumerate(bt.ids) if u is not None and u not in skip]
        np.testing.assert_array_equal(bt.audio[rows], bj.audio[rows])
    sj, st = jio.DecodeStats(), tio.DecodeStats()
    want = [(p, x) for p, x in jio.decode_stream(feed_corpus, jcfg, num_threads=3, stats=sj)]
    got = [(p, x) for p, x in tio.decode_stream(feed_corpus, tcfg, num_threads=3, stats=st)]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _stats(st) == _stats(sj)
    assert tio.shard_files(feed_corpus, 1, 3) == jio.shard_files(feed_corpus, 1, 3)


class _Event:
    """A stand-in for a CUDA event: records when the pool waits on it."""

    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append("waited")


def test_row_pool_waits_for_the_copy_before_reuse():
    log = []
    pool = RowPool(capacity=2)
    a = pool.take(4, 100, np.int16)
    a[:] = 1
    pool.give(a, [_Event(log), _Event(log)])
    assert log == []  # giving back does not wait
    b = pool.take(4, 100, np.int16)
    assert b is a and log == ["waited", "waited"]
    c = pool.take(4, 100, np.int16)
    assert c is not a  # the pool was empty: a new buffer
    for buf in (a, c, pool.take(4, 100, np.int16)):
        pool.give(buf)
    assert len(pool._free[(4, 100, np.dtype(np.int16))]) == 2  # capacity
    assert pool.take(4, 100, np.float32).dtype == np.float32


def test_direct_feed_release_hands_the_rows_back(feed_corpus):
    cfg = T_CONFIGS["classic13"]
    log = []
    pool = RowPool(capacity=4)
    seen = []
    for b in tio.stream_batches_direct(feed_corpus, cfg, batch_size=1, max_len_s=4.0,
                                       n_buckets=1, dtype="i16", pool=pool):
        b.copy_events.append(_Event(log))
        seen.append(b.audio.__array_interface__["data"][0])
        b.release()
    assert log  # a refilled buffer waited on its copy's event
    assert len(set(seen)) < len(seen)  # buffers were reused


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _features(cfg, n_utts=3, seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal((f, cfg.feat_dim)).astype(np.float32) for f in (5, 0, 17)[:n_utts]]


def _npz_members(path) -> dict[str, bytes]:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _marker(path) -> dict:
    meta = json.loads(pathlib.Path(path).read_text())
    meta.pop("written_at")
    return meta


@pytest.mark.parametrize("fmt", ["npz", "htk", "kaldi"])
@pytest.mark.parametrize("config_name", ["classic13_deltas", "kaldi_spectrogram", "kaldi_plp", "logmel80"])
def test_writers_match_reference(tmp_path, fmt, config_name):
    jcfg, tcfg = J_CONFIGS[config_name], T_CONFIGS[config_name]
    ids = ["a/u1.wav", "b/u1.wav", "c d/u 2.wav"]
    feats = _features(tcfg)
    extra = {"moments": {"s1": [1.0], "s2": [2.0], "n": 3.0}}
    jw = jio.ShardWriter(tmp_path / "j", jcfg, fmt=fmt)
    tw = tio.ShardWriter(tmp_path / "t", tcfg, fmt=fmt)
    jw.write("h0-000000", ids, feats, extra_meta=extra)
    tw.write("h0-000000", ids, [torch.as_tensor(f).numpy() for f in feats], extra_meta=extra)
    assert _marker(tmp_path / "t/done/h0-000000.json") == _marker(tmp_path / "j/done/h0-000000.json")
    names = sorted(p.name for p in (tmp_path / "j").iterdir() if p.is_file())
    assert sorted(p.name for p in (tmp_path / "t").iterdir() if p.is_file()) == names
    for name in names:
        a, b = (tmp_path / "t" / name), (tmp_path / "j" / name)
        if name.endswith(".npz"):
            assert _npz_members(a) == _npz_members(b)
        elif name.endswith(".scp"):
            assert a.read_text().replace(str(tmp_path / "t"), "") == \
                b.read_text().replace(str(tmp_path / "j"), "")
        else:
            assert a.read_bytes() == b.read_bytes()
    # markers and resume in both directions
    assert tw.is_done("h0-000000", ids) and jw.is_done("h0-000000", ids)
    assert tio.ShardWriter(tmp_path / "j", tcfg, fmt=fmt).is_done("h0-000000", ids)
    assert jio.ShardWriter(tmp_path / "t", jcfg, fmt=fmt).is_done("h0-000000", ids)
    assert not tio.ShardWriter(tmp_path / "j", tcfg, fmt=fmt).is_done("h0-000000", ids[:2])
    assert tw.marker_meta("h0-000000")["extra"] == extra
    if fmt == "npz":
        got, want = tio.read_shard(a), jio.read_shard(b)
        assert list(got) == list(want)
        assert tio.writer.iter_feature_shards(tmp_path / "t") == [tmp_path / "t/h0-000000.npz"]
        assert tio.writer.npz_member_shape(a, "features") == (22, tcfg.feat_dim)


@pytest.mark.parametrize("config_name", ["classic13_deltas", "kaldi_mfcc", "kaldi_plp",
                                         "kaldi_spectrogram", "ssc26", "classic13_deltas_gcmvn"])
def test_htk_kinds_and_roundtrip(tmp_path, config_name):
    jcfg, tcfg = J_CONFIGS[config_name], T_CONFIGS[config_name]
    assert thtk.parm_kind(tcfg) == jhtk.parm_kind(jcfg)
    assert thtk.kind_string(thtk.parm_kind(tcfg)) == jhtk.kind_string(jhtk.parm_kind(jcfg))
    pt, pj = thtk.energy_last_permutation(tcfg), jhtk.energy_last_permutation(jcfg)
    assert (pt is None and pj is None) or np.array_equal(pt, pj)
    feat = _features(tcfg)[2]
    thtk.write_htk(tmp_path / "t.htk", feat, tcfg)
    jhtk.write_htk(tmp_path / "j.htk", feat, jcfg)
    assert (tmp_path / "t.htk").read_bytes() == (tmp_path / "j.htk").read_bytes()
    got, meta = thtk.read_htk(tmp_path / "j.htk")
    want, jmeta = jhtk.read_htk(tmp_path / "t.htk")
    np.testing.assert_array_equal(got, want)
    assert meta == jmeta


def test_kaldi_keys_and_readers(tmp_path):
    for uid in ("a/b.wav", "u 1.wav", "u_1.wav", "", 7):
        assert tkaldi.ark_key(uid) == jkaldi.ark_key(uid)
    feats = _features(T_CONFIGS["classic13"])
    with tkaldi.ArkWriter(tmp_path / "s") as w:
        for i, f in enumerate(feats):
            w.add(f"utt{i}", f)
    for reader in (tkaldi.read_ark, jkaldi.read_ark):
        got = reader(tmp_path / "s.ark")
        assert list(got) == ["utt0", "utt1", "utt2"]
        for f, g in zip(feats, got.values()):
            np.testing.assert_array_equal(f, g)
    assert list(tkaldi.read_scp(tmp_path / "s.scp")) == list(jkaldi.read_scp(tmp_path / "s.scp"))
    with pytest.raises(ValueError, match="duplicate"):
        with tkaldi.ArkWriter(tmp_path / "d") as w:
            w.add("x", feats[0])
            w.add("x", feats[0])
    assert not (tmp_path / "d.ark").exists()


def test_trim_batch_takes_tensors():
    feat = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 0]], np.float32)
    want = jio.trim_batch(feat, mask)
    for f, m in ((feat, mask), (torch.as_tensor(feat), torch.as_tensor(mask))):
        got = tio.trim_batch(f, m)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# CMVN accumulators
# ---------------------------------------------------------------------------


def test_cmvn_accumulators_match_reference(tmp_path):
    cfg_t, cfg_j = T_CONFIGS["classic13_deltas_gcmvn"], J_CONFIGS["classic13_deltas_gcmvn"]
    g = np.random.default_rng(7)
    D = cfg_t.feat_dim
    ta, ja = tcmvn.CmvnAccumulator(D), jcmvn.CmvnAccumulator(D)
    ts, js = tcmvn.SpeakerCmvnAccumulator(D), jcmvn.SpeakerCmvnAccumulator(D)
    for i in range(5):
        s1, s2, n = g.standard_normal(D) * 10, np.abs(g.standard_normal(D)) * 100, float(g.integers(1, 99))
        ta.add(s1, s2, n)
        ja.add(s1, s2, n)
        ts.add(f"spk{i % 2}", s1, s2, n)
        js.add(f"spk{i % 2}", s1, s2, n)
    st, sj = ta.finalize(cfg_t), ja.finalize(cfg_j)
    np.testing.assert_array_equal(st.mean, sj.mean)
    np.testing.assert_array_equal(st.std, sj.std)
    assert st.n == sj.n
    for a, b in zip(ts.finalize(cfg_t).items(), js.finalize(cfg_j).items()):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1].mean, b[1].mean)
    # each package loads the other's moments files
    ta.save(tmp_path / "t.npz")
    ja.save(tmp_path / "j.npz")
    ts.save(tmp_path / "ts.npz")
    js.save(tmp_path / "js.npz")
    for path in ("t.npz", "j.npz"):
        got, want = tcmvn.CmvnAccumulator.load(tmp_path / path), jcmvn.CmvnAccumulator.load(tmp_path / path)
        np.testing.assert_array_equal(got.s1, want.s1)
        np.testing.assert_array_equal(got.s2, want.s2)
        assert got.n == want.n == ta.n
        assert not tcmvn.is_speaker_stats(tmp_path / path)
    for path in ("ts.npz", "js.npz"):
        got, want = tcmvn.SpeakerCmvnAccumulator.load(tmp_path / path), \
            jcmvn.SpeakerCmvnAccumulator.load(tmp_path / path)
        assert sorted(got.pools) == sorted(want.pools) == ["spk0", "spk1"]
        for k in got.pools:
            np.testing.assert_array_equal(got.pools[k].s1, want.pools[k].s1)
        assert tcmvn.is_speaker_stats(tmp_path / path) and jcmvn.is_speaker_stats(tmp_path / path)
    with pytest.raises(ValueError, match="not a speaker"):
        tcmvn.SpeakerCmvnAccumulator.load(tmp_path / "j.npz")
    # apply_cmvn in float64
    feat = g.standard_normal((2, 6, D))
    mask = np.array([[1] * 6, [1] * 3 + [0] * 3], np.float64)
    for var_norm in (True, False):
        got = tcmvn.apply_cmvn(torch.as_tensor(feat), torch.as_tensor(mask), st.mean, st.std, var_norm)
        want = np.asarray(jcmvn.apply_cmvn(feat, mask, sj.mean, sj.std, var_norm))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
        assert not got[1, 3:].any()


def test_speaker_maps_match_reference(tmp_path):
    (tmp_path / "u2s").write_text("# comment\nu1 alice\n\nu2.wav bob\n")
    m = tcmvn.read_utt2spk(tmp_path / "u2s")
    assert m == jcmvn.read_utt2spk(tmp_path / "u2s")
    for uid in ("/c/x/u1.wav", "d/u2.wav", "spk/z.wav", "z.wav"):
        assert tcmvn.speaker_of(uid) == jcmvn.speaker_of(uid)
    for uid in ("/c/x/u1.wav", "u2.wav"):
        assert tcmvn.speaker_of(uid, m) == jcmvn.speaker_of(uid, m)
    with pytest.raises(KeyError):
        tcmvn.speaker_of("nobody.wav", m)
    (tmp_path / "bad").write_text("u1 a b\n")
    with pytest.raises(ValueError):
        tcmvn.read_utt2spk(tmp_path / "bad")
