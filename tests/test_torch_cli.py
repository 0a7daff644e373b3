"""The port's CLI (`python -m mfcc_tpu_torch.cli`) ≡ the JAX package's
(`mfcc_tpu.cli` with `--backend jnp --feed direct`), on the CPU.

A tiny corpus (speaker subdirectories, two files over `--max-len-s 1.0` that
split, a corrupt file and one at the wrong rate) goes through both CLIs:
the shard names, ids, markers and moments match, and the features are
within each family's gate, for extract (npz, HTK and Kaldi), the two-pass
global and speaker CMVN (`apply-cmvn`), and a resume across the two
packages in both directions. 60,000 filters, refused before, extract
through either feed; `--device cuda` without a card, or a float64 config
on the card, exits non-zero with no shard written;
`--feed auto` takes the multi-process feed where the C++ decoder builds.
(`--batch-size 8`: the JAX package's tests run it on 8 CPU devices, whose
mesh rounds the batch up to a multiple of 8.)
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mfcc_tpu.cli import main as jmain
from mfcc_tpu.io import read_ark as jread_ark
from mfcc_tpu.io import read_shard as jread_shard
from mfcc_tpu_torch.cli import main as tmain
from mfcc_tpu_torch.config import NAMED_CONFIGS
from mfcc_tpu_torch.io import read_ark, read_htk, read_shard, write_wav
from mfcc_tpu_torch.parallel import cmvn as tcmvn
from mfcc_tpu_torch.testing import assert_features_close, assert_logmel_close, assert_whisper_features_close

REPO = pathlib.Path(__file__).resolve().parents[1]
COMMON = ["--batch-size", "8", "--threads", "2", "--max-len-s", "1.0", "--feed", "direct"]
# the moments: float32 sums over ~1,000 frames in another order, of features
# that agree to ~1e-5; a column whose sum is near 0 is held to MOMENT_ATOL
CMVN_RTOL, MOMENT_ATOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    g = np.random.default_rng(11)
    for i, n in enumerate([8000, 23000, 5000, 41000, 16000, 2000, 15000, 9000, 12000, 7000, 4000]):
        sub = d / f"spk{i % 3}"
        sub.mkdir(exist_ok=True)
        # noise under a slow random envelope, so the log energy varies
        env = np.repeat(g.uniform(0.05, 1.0, n // 800 + 1), 800)[:n]
        write_wav(sub / f"utt{i}.wav", 16000, (g.standard_normal(n) * 6000 * env).astype(np.int16))
    (d / "spk0" / "bad.wav").write_bytes(b"RIFF not a wav")
    write_wav(d / "spk1" / "r8k.wav", 8000, np.zeros(800, np.int16))
    return d


def _run(tmp, corpus, *extra, ref: bool = False, out: str | None = None):
    out = tmp / (out or ("j" if ref else "t"))
    device = ["--backend", "jnp"] if ref else ["--device", "cpu"]
    rc = (jmain if ref else tmain)(["extract", str(corpus), "-o", str(out), *device, *COMMON, *extra])
    return rc, out


def _markers(out: pathlib.Path) -> dict:
    res = {}
    for p in sorted((out / "done").glob("h*.json")):
        meta = json.loads(p.read_text())
        meta.pop("written_at")
        res[p.name] = meta
    return res


def _close(cfg, got, want):
    if cfg.features == "mfcc":
        assert_features_close(got, want)
    else:
        assert_logmel_close(got, want, cfg.log_kind)


def _compare_markers(got: dict, want: dict):
    assert list(got) == list(want)
    for name in got:
        g, w = dict(got[name]), dict(want[name])
        ge, we = g.pop("extra", None), w.pop("extra", None)
        assert g == w, name
        assert (ge is None) == (we is None)
        if ge and "moments" in ge:
            for k in ("s1", "s2"):
                np.testing.assert_allclose(ge["moments"][k], we["moments"][k], rtol=CMVN_RTOL, atol=MOMENT_ATOL)
            assert ge["moments"]["n"] == we["moments"]["n"]


@pytest.mark.parametrize("config_name", ["classic13_deltas", "kaldi_fbank"])
def test_extract_matches_reference_cli(tmp_path, corpus, config_name):
    cfg = NAMED_CONFIGS[config_name]
    rc_j, j = _run(tmp_path, corpus, "--config", config_name, ref=True)
    rc_t, t = _run(tmp_path, corpus, "--config", config_name, "--metrics", str(tmp_path / "m.jsonl"))
    assert rc_j == rc_t == 0
    names = sorted(p.name for p in j.glob("*.npz"))
    assert sorted(p.name for p in t.glob("*.npz")) == names
    assert "h0-long-000000.npz" in names and "h0-000000.npz" in names
    _compare_markers(_markers(t), _markers(j))
    n_utts = 0
    for name in names:
        got, want = read_shard(t / name), jread_shard(j / name)
        assert list(got) == list(want)
        for k in got:
            _close(cfg, got[k], want[k])
        n_utts += len(got)
    assert n_utts == 11
    done = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert done["event"] == "done" and done["utterances"] == 11
    assert (done["decode_errors"], done["wrong_rate"], done["long_split"]) == (1, 1, 2)


@pytest.fixture(scope="module")
def corpus48(tmp_path_factory):
    """Whisper-style input at 48 kHz: five files of 0.1-1.6 s (two over
    --max-len-s 1.0, which split) and one at 16 kHz, the wrong rate."""
    d = tmp_path_factory.mktemp("corpus48")
    g = np.random.default_rng(48)
    for i, n in enumerate([24000, 76801, 4800, 48000, 60013]):
        env = np.repeat(g.uniform(0.05, 1.0, n // 2400 + 1), 2400)[:n]
        write_wav(d / f"utt{i}.wav", 48000, (g.standard_normal(n) * 6000 * env).astype(np.int16))
    write_wav(d / "r16k.wav", 16000, np.zeros(1600, np.int16))
    return d


def test_extract_whisper80_fed_48k_matches_reference_cli(tmp_path, corpus48):
    """`extract --config whisper80 --set input_sample_rate=48000` (centered
    framing of resampled rows, which the port refused with exit 2 before)
    writes the reference CLI's shards, ids and markers, each utterance
    within whisper80's gate (5e-5), the long files through the resampled
    long-file path."""
    conf = ["--config", "whisper80", "--set", "input_sample_rate=48000", "--metrics",
            str(tmp_path / "m.jsonl")]
    rc_j, j = _run(tmp_path, corpus48, *conf[:4], ref=True)
    rc_t, t = _run(tmp_path, corpus48, *conf)
    assert rc_j == rc_t == 0
    names = sorted(p.name for p in j.glob("*.npz"))
    assert sorted(p.name for p in t.glob("*.npz")) == names and names
    _compare_markers(_markers(t), _markers(j))
    n_utts = 0
    for name in names:
        got, want = read_shard(t / name), jread_shard(j / name)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape and got[k].shape[-1] == 80
            assert_whisper_features_close(got[k], want[k])
        n_utts += len(got)
    assert n_utts == 5
    done = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert (done["utterances"], done["wrong_rate"], done["long_split"]) == (5, 1, 2)


def _normalized_close(got: dict, want: dict, stats_path, cfg):
    """Normalized shards within the feature gate before the division: each
    difference times min(1, std) of its column (a column of small spread,
    such as c0's log energy on noise, divides fp32 noise up by 1/std;
    `testing.cmvn_column_scale` holds the feature tail the same way)."""
    if tcmvn.is_speaker_stats(stats_path):
        by_spk = tcmvn.SpeakerCmvnAccumulator.load(stats_path).finalize(cfg)
        std = {k: by_spk[tcmvn.speaker_of(k)].std for k in got}
    else:
        g = tcmvn.CmvnAccumulator.load(stats_path).finalize(cfg).std
        std = {k: g for k in got}
    assert list(got) == list(want)
    for k in got:
        scale = np.minimum(1.0, std[k])
        assert_features_close(got[k] * scale, want[k] * scale)


@pytest.mark.parametrize("mode", ["global", "speaker"])
def test_two_pass_cmvn_matches_reference_cli(tmp_path, corpus, mode):
    conf = ["--config", "classic13_deltas_gcmvn"] + (["--set", "cmvn=speaker"] if mode == "speaker" else [])
    rc_j, j = _run(tmp_path, corpus, *conf, ref=True)
    rc_t, t = _run(tmp_path, corpus, *conf)
    assert rc_j == rc_t == 0
    _compare_markers(_markers(t), _markers(j))
    stats_t, stats_j = t / "cmvn_moments_h0.npz", j / "cmvn_moments_h0.npz"
    with np.load(stats_t) as a, np.load(stats_j) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(a[k], b[k], rtol=CMVN_RTOL, atol=MOMENT_ATOL)
            else:
                np.testing.assert_array_equal(a[k], b[k])
    # each package's apply-cmvn on its own shards with its own moments, and
    # the port's on its shards with the JAX package's moments file
    assert jmain(["apply-cmvn", str(j), "--stats", str(stats_j), *conf]) == 0
    assert tmain(["apply-cmvn", str(t), "--stats", str(stats_t), *conf]) == 0
    names = sorted(p.name for p in j.glob("h*.npz"))
    cfg = NAMED_CONFIGS["classic13_deltas_gcmvn"].replace(cmvn=mode)
    assert tmain(["apply-cmvn", str(t), "--stats", str(stats_t), *conf]) == 0  # idempotent
    marker = json.loads((t / "done" / "cmvn_applied.json").read_text())
    assert marker["shards"] == len(names)
    t2 = tmp_path / "t2"
    _run(tmp_path, corpus, *conf, out="t2")
    assert tmain(["apply-cmvn", str(t2), "--stats", str(stats_j), *conf]) == 0
    for name in names:
        _normalized_close(read_shard(t2 / name), jread_shard(j / name), stats_j, cfg)
    if mode == "global":
        feats = np.concatenate([f for n in names for f in read_shard(t / n).values()])
        np.testing.assert_allclose(feats.mean(axis=0), 0.0, atol=1e-3)
        np.testing.assert_allclose(feats.std(axis=0), 1.0, atol=1e-3)


@pytest.mark.parametrize("fmt", ["htk", "kaldi"])
def test_formats_match_reference_cli(tmp_path, corpus, fmt):
    conf = ["--config", "classic13_deltas", "--format", fmt]
    assert _run(tmp_path, corpus, *conf, ref=True)[0] == 0
    assert _run(tmp_path, corpus, *conf)[0] == 0
    j, t = tmp_path / "j", tmp_path / "t"
    files = sorted(p.name for p in j.iterdir() if p.is_file())
    assert sorted(p.name for p in t.iterdir() if p.is_file()) == files
    _compare_markers(_markers(t), _markers(j))
    if fmt == "htk":
        for name in files:
            got, meta = read_htk(t / name)
            want, jmeta = read_htk(j / name)
            assert meta == jmeta
            assert_features_close(got, want)
    else:
        for name in (f for f in files if f.endswith(".ark")):
            got, want = read_ark(t / name), jread_ark(j / name)
            assert list(got) == list(want)
            for k in got:
                assert_features_close(got[k], want[k])


def test_resume_works_across_the_packages(tmp_path, corpus, caplog):
    conf = ["--config", "classic13_deltas_gcmvn"]
    assert _run(tmp_path, corpus, *conf, ref=True, out="shared")[0] == 0
    before = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "shared").glob("h*.npz")}
    moments = np.load(tmp_path / "shared" / "cmvn_moments_h0.npz")["s1"]
    assert _run(tmp_path, corpus, *conf, "--metrics", str(tmp_path / "m.jsonl"), out="shared")[0] == 0
    after = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "shared").glob("h*.npz")}
    assert after == before  # every shard skipped, none rewritten
    done = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert done["shards_skipped"] == len(before)
    # the moments came back from the JAX package's markers
    np.testing.assert_allclose(np.load(tmp_path / "shared" / "cmvn_moments_h0.npz")["s1"], moments,
                               rtol=1e-12)
    # and the other way: the port writes, the JAX package resumes
    assert _run(tmp_path, corpus, *conf, out="other")[0] == 0
    before = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "other").glob("h*.npz")}
    assert _run(tmp_path, corpus, *conf, ref=True, out="other")[0] == 0
    assert {p.name: p.stat().st_mtime_ns for p in (tmp_path / "other").glob("h*.npz")} == before


def test_refusals_exit_without_writing(tmp_path, corpus, caplog):
    """60,000 filters, refused before on both devices (over the packed mel
    table's filter field), now extract on the CPU through either feed: the
    shards and ids of the reference CLI, the features within the cepstra
    gate of the same run in float64 and no further from it than the
    reference's (whose DCT over 60,000 lanes sums in fp32); n_fft 4096 (the
    block FFT plan) and 16384 (the packed bands read from device memory),
    refused before, extract too, at 16384 the reference CLI's shards within
    the cepstra gate. What is still refused exits 2 and writes nothing:
    `--device cuda` without a card, and a float64 config on the card."""
    many = ("--set", "n_mels=60000")
    rc_t, t = _run(tmp_path, corpus, *many, "--feed", "mp", out="m60k")
    rc_f, f = _run(tmp_path, corpus, *many, "--set", "dtype=float64", out="m60k64")
    rc_j, j = _run(tmp_path, corpus, *many, ref=True, out="j60k")
    assert rc_t == rc_f == rc_j == 0
    names = sorted(p.name for p in j.glob("*.npz"))
    assert sorted(p.name for p in t.glob("*.npz")) == sorted(p.name for p in f.glob("*.npz")) == names and names
    for name in names:
        got, want, ref = read_shard(t / name), read_shard(f / name), jread_shard(j / name)
        assert list(got) == list(want) == list(ref)
        for k in got:
            assert_features_close(got[k], want[k])
            err = np.abs(got[k].astype(np.float64) - want[k]).max()
            assert err <= np.abs(ref[k].astype(np.float64) - want[k]).max(), (name, k)
    rc, ran = _run(tmp_path, corpus, "--set", "n_fft=4096", out="n4096")
    assert rc == 0 and list(ran.rglob("*.npz"))
    rc_t, t = _run(tmp_path, corpus, "--set", "n_fft=16384", out="n16384")
    rc_j, j = _run(tmp_path, corpus, "--set", "n_fft=16384", ref=True, out="j16384")
    assert rc_t == rc_j == 0
    names = sorted(p.name for p in j.glob("*.npz"))
    assert sorted(p.name for p in t.glob("*.npz")) == names and names
    for name in names:
        got, want = read_shard(t / name), jread_shard(j / name)
        assert list(got) == list(want)
        for k in got:
            assert_features_close(got[k], want[k])
    out = tmp_path / "o"
    if not torch.cuda.is_available():
        assert tmain(["extract", str(corpus), "-o", str(out), "--config", "classic13", *many]) == 2
        assert "no CUDA device" in caplog.text
    caplog.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        rc = tmain(["extract", str(corpus), "-o", str(out), "--set", "dtype=float64", "--device", "cuda"])
    assert rc == 2 and "float32, not float64" in caplog.text
    assert not out.exists() or not list(out.rglob("*.npz"))


def test_module_entry_point_without_a_card(tmp_path, corpus):
    """`python -m mfcc_tpu_torch.cli extract --device cuda` with no card
    visible exits non-zero and writes no shard; `--device cpu --feed auto`
    runs the multi-process feed where the C++ decoder builds (else the
    arrays feed), and says which."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    out = tmp_path / "o"
    res = subprocess.run([sys.executable, "-m", "mfcc_tpu_torch.cli", "extract", str(corpus), "-o", str(out),
                          "--device", "cuda"], env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not out.exists() or not list(out.rglob("*.npz"))
    res = subprocess.run([sys.executable, "-m", "mfcc_tpu_torch.cli", "extract", str(corpus / "spk2"), "-o",
                          str(out), "--device", "cpu", "--batch-size", "2"], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    from mfcc_tpu_torch.io.wav import _native

    assert f"--feed auto: the {'multi-process' if _native() is not None else 'arrays'} feed" in res.stderr
    assert len(list(out.glob("h0-*.npz"))) == 2
