"""The port's multi-process feed (`mfcc_tpu_torch.io.reader.stream_batches_mp`,
`io/feed_worker.py`) on the CPU:

- batches byte-identical to the port's direct feed and to the JAX package's
  `stream_batches_mp(layouts="resample")` on a config that does not
  resample, for int16 and float32 rows, with a corrupt file, a file at the
  wrong rate, an empty one and two over the top bucket (deferred and
  truncated), with skip_ids, and from a lazy file iterable;
- the workers: death resolves a chunk as failed and the slot respawns, the
  changed-file guard fails a row whose decode disagrees with its header,
  header errors and wrong rates keep their stats, a dead header chunk falls
  back to the serial parse;
- `MpPoolCache`'s reference counting, on a fresh cache;
- the slab files: named with the pool's own prefix, all gone after a
  stream; a slab given back with copy events is decoded into again only
  after they were waited on;
- `python -m mfcc_tpu_torch.io.feed_worker` loads no torch;
- `cli extract --feed mp` writes the same shards as `--feed direct`, and
  `--feed auto` takes the mp feed where the C++ decoder builds.
The JAX package's feed writes its slabs into a temporary directory here, not
/dev/shm, so no slab of this file is ever seen by its own cleanup test.
"""

import logging
import os
import pathlib
import subprocess
import sys
import threading
import time
import zipfile

import numpy as np
import pytest

from mfcc_tpu import io as jio
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.io import reader as jreader
from mfcc_tpu_torch import io as tio
from mfcc_tpu_torch.cli import main as tmain
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.io import reader
from mfcc_tpu_torch.io.wav import _native

REPO = pathlib.Path(__file__).resolve().parents[1]
needs_native = pytest.mark.skipif(_native() is None, reason="needs the C++ wav decoder (g++)")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp")
    g = np.random.default_rng(17)
    paths = []
    for i, n in enumerate([4000, 50000, 175000, 9000, 70000, 3000, 22000, 111000, 12000, 400, 66000]):
        p = d / f"u{i:02d}.wav"
        tio.write_wav(p, 16000, (g.standard_normal(n) * 1000).astype(np.int16))
        paths.append(str(p))
    (d / "bad.wav").write_bytes(b"RIFF not a wav")
    paths.insert(2, str(d / "bad.wav"))
    tio.write_wav(d / "wrong.wav", 8000, np.zeros(100, np.int16))
    paths.insert(5, str(d / "wrong.wav"))
    tio.write_wav(d / "empty.wav", 16000, np.zeros(0, np.int16))
    paths.insert(8, str(d / "empty.wav"))
    return paths


@pytest.fixture()
def fresh_cache():
    cache = reader.MpPoolCache()
    yield cache
    cache.close()


def _stats(s) -> tuple:
    return (s.decoded, s.errors, s.wrong_rate, s.truncated, s.long_deferred,
            [str(p) for p in s.long_paths], round(s.audio_seconds, 9))


def _assert_same(got: list, want: list) -> None:
    assert len(got) == len(want) > 2
    for bt, bw in zip(got, want):
        assert bt.ids == bw.ids
        assert bt.audio.dtype == bw.audio.dtype and bt.audio.shape == bw.audio.shape
        assert bt.audio.tobytes() == bw.audio.tobytes()
        np.testing.assert_array_equal(bt.lengths, bw.lengths)


@pytest.mark.parametrize("dtype", ["i16", "f32"])
@pytest.mark.parametrize("long_mode", ["defer", "truncate"])
def test_mp_feed_matches_direct_and_reference(corpus, dtype, long_mode, fresh_cache, tmp_path, monkeypatch):
    monkeypatch.setattr(jreader, "_shm_dir", lambda: str(tmp_path))  # the reference's slabs
    cfg, jcfg = T_CONFIGS["classic13"], J_CONFIGS["classic13"]
    kw = dict(batch_size=3, max_len_s=4.0, n_buckets=3, num_threads=2, long_mode=long_mode, dtype=dtype)
    sd, sm, sj = tio.DecodeStats(), tio.DecodeStats(), jio.DecodeStats()
    direct = list(tio.stream_batches_direct(corpus, cfg, stats=sd, **kw))
    slabs = reader.SlabPool()
    got = list(tio.stream_batches_mp(corpus, cfg, stats=sm, slabs=slabs, pool_cache=fresh_cache, **kw))
    want = list(jio.stream_batches_mp(corpus, jcfg, stats=sj, layouts="resample", **kw))
    _assert_same(got, direct)
    _assert_same(got, want)
    for b in got + want:
        b.release()
    assert _stats(sm) == _stats(sd) == _stats(sj)
    assert sm.errors == 2 and sm.wrong_rate == 1
    assert (sm.long_deferred, sm.truncated) == ((4, 0) if long_mode == "defer" else (0, 4))
    assert not list(pathlib.Path(slabs.directory).glob(slabs.prefix + "*"))


def test_mp_feed_skip_ids_and_lazy_files(corpus, fresh_cache):
    """skip_ids keeps the batches' composition and lengths and leaves the
    skipped rows undecoded; a generator of files (the serial header parse)
    gives the same batches as the list."""
    cfg = T_CONFIGS["classic13"]
    skip = frozenset(corpus[:4])
    kw = dict(batch_size=4, max_len_s=4.0, dtype="i16", num_threads=2, pool_cache=fresh_cache)
    direct = list(tio.stream_batches_direct(corpus, cfg, batch_size=4, max_len_s=4.0, dtype="i16",
                                            skip_ids=skip))
    got = list(tio.stream_batches_mp(corpus, cfg, skip_ids=skip, **kw))
    assert [b.ids for b in got] == [b.ids for b in direct]
    for bt, bd in zip(got, direct):
        np.testing.assert_array_equal(bt.lengths, bd.lengths)
        rows = [i for i, u in enumerate(bt.ids) if u is not None and u not in skip]
        np.testing.assert_array_equal(bt.audio[rows], bd.audio[rows])
    lazy = list(tio.stream_batches_mp((p for p in corpus), cfg, **kw))
    listed = list(tio.stream_batches_mp(list(corpus), cfg, **kw))
    _assert_same(lazy, listed)


class _Event:
    """A stand-in for a CUDA copy event: records when it was waited on."""

    def __init__(self):
        self.waited = False

    def synchronize(self):
        self.waited = True


class _RecordingSlabs(reader.SlabPool):
    """A SlabPool that remembers the events each slab was given back with."""

    def __init__(self):
        super().__init__()
        self.events: dict[str, list] = {}

    def give(self, arr, events=()):
        self.events.setdefault(arr.filename, []).extend(events)
        super().give(arr, events)


class _CheckedCache(reader.MpPoolCache):
    """A pool cache whose pool checks every decode_chunk: its slab's copy
    events have all been waited on before the slab is decoded into again."""

    def __init__(self, slabs):
        super().__init__()
        self.slabs, self.refills = slabs, 0

    def acquire(self, num_workers):
        pool, private = super().acquire(num_workers)
        submit = pool.submit

        def checked(cmd):
            if cmd["op"] == "decode_chunk":
                given = self.slabs.events.get(cmd["slab"], [])
                assert all(ev.waited for ev in given), "a slab refilled under its copy"
                self.refills += bool(given)
            return submit(cmd)

        pool.submit = checked
        return pool, private


def test_a_slab_is_not_refilled_before_its_copy_event(corpus):
    cfg = T_CONFIGS["classic13"]
    slabs = _RecordingSlabs()
    cache = _CheckedCache(slabs)
    try:
        n = 0
        for b in tio.stream_batches_mp(corpus, cfg, batch_size=1, max_len_s=4.0, n_buckets=1, dtype="i16",
                                       num_threads=2, slabs=slabs, pool_cache=cache):
            b.copy_events.append(_Event())
            b.release()
            n += 1
        assert n >= 6 and cache.refills > 0  # slabs were reused, each after its event
        assert not list(pathlib.Path(slabs.directory).glob(slabs.prefix + "*"))
    finally:
        cache.close()


def test_slab_pool_prefix_take_give_close(tmp_path):
    a, b = reader.SlabPool(directory=str(tmp_path)), reader.SlabPool(directory=str(tmp_path))
    assert a.prefix != b.prefix and str(os.getpid()) in a.prefix
    arr = a.take(4, 100, np.int16)
    name = arr.filename
    assert pathlib.Path(name).name.startswith(a.prefix) and arr.shape == (4, 100) and a.names == [name]
    ev = _Event()
    a.give(arr, [ev])
    assert not ev.waited  # giving back does not wait
    arr2 = a.take(4, 100, np.int16)
    assert arr2 is arr and ev.waited
    other = a.take(4, 100, np.float32)
    assert other.filename != name
    b.take(2, 10, np.int16)
    a.close()
    left = sorted(p.name for p in tmp_path.iterdir())
    assert len(left) == 1 and left[0].startswith(b.prefix)  # only the other pool's file
    b.close()
    assert not list(tmp_path.iterdir())


def test_worker_death_fails_the_chunk_and_the_slot_respawns(corpus, tmp_path):
    pool = reader._MpPool(2)
    try:
        # a missing slab file: np.memmap raises in the worker, which exits;
        # the EOF resolves the job with an error
        job = pool.submit({"op": "decode_chunk", "slab": str(tmp_path / "missing"), "shape": [1, 10],
                           "dtype": "i16", "blen": 10, "sr": 16000, "jobs": [[0, corpus[0], 4000]]})
        assert job.event.wait(timeout=60)
        assert job.error == "feed worker died"
        pool._procs[1].kill()
        pool._procs[1].wait(timeout=10)
        time.sleep(0.2)  # its reader thread runs the EOF cleanup
        errs = []
        for _ in range(4):  # round-robin reaches both slots twice
            job = pool.submit({"op": "nope"})
            assert job.event.wait(timeout=60)
            errs.append(job.error)
        assert errs == ["unknown op 'nope'"] * 4
        assert all(p.poll() is None for p in pool._procs)
        job = pool.submit({"op": "ping"})
        assert job.event.wait(timeout=60) and job.error is None
    finally:
        pool.close()
    assert not pool.alive()


def test_feed_worker_rejects_a_changed_file(corpus, tmp_path):
    """A decode_chunk whose expected sample count is not the decode's fails
    that row and zeroes it; the tail past blen is zeroed."""
    slabs = reader.SlabPool(directory=str(tmp_path))
    arr = slabs.take(3, 8000, np.int16)
    name = arr.filename
    arr[:] = 7
    pool = reader._MpPool(1)
    try:
        job = pool.submit({"op": "decode_chunk", "slab": name, "shape": [3, 8000], "dtype": "i16",
                           "blen": 6000, "downmix": "first", "sr": 16000,
                           "jobs": [[0, corpus[0], 4000], [1, corpus[1], 9999]]})
        assert job.event.wait(timeout=60) and job.error is None
    finally:
        pool.close()
    assert [f[0] for f in job.fails] == [1] and "changed since header parse" in job.fails[0][1]
    assert arr[0, :4000].any() and not arr[0, 4000:].any()
    assert not arr[1].any()
    assert (arr[2] == 7).all()  # a row with no job is left alone
    slabs.close()


def test_header_stream_errors_and_dead_worker_fallback(corpus, fresh_cache):
    cfg = T_CONFIGS["classic13"]
    pool, private = fresh_cache.acquire(2)
    try:
        st = tio.DecodeStats()
        out = list(reader._mp_header_stream(corpus, pool, 16000, st, chunk=3, depth=2))
    finally:
        fresh_cache.release(pool, private)
    serial = tio.DecodeStats()
    want = [(p, reader._parse_header_counted(p, 16000, serial)) for p in corpus]
    assert out == [(p, n) for p, n in want if n is not None]
    assert (st.errors, st.wrong_rate) == (serial.errors, serial.wrong_rate) == (1, 1)

    class _DeadJob:
        def __init__(self):
            self.event = threading.Event()
            self.event.set()
            self.error, self.heads = "feed worker died", None

    class _DeadPool:
        def submit(self, cmd):
            assert cmd["op"] == "parse_headers"
            return _DeadJob()

    st = tio.DecodeStats()
    assert list(reader._mp_header_stream(corpus, _DeadPool(), cfg.sample_rate, st, chunk=4, depth=2)) == out
    assert (st.errors, st.wrong_rate) == (1, 1)


@needs_native
def test_pool_cache_refcounting_on_a_fresh_cache(fresh_cache):
    """A concurrent stream with another worker count gets a private pool;
    the cached pool is never closed under a user."""
    a, a_priv = fresh_cache.acquire(2)
    assert not a_priv
    b, b_priv = fresh_cache.acquire(3)  # the cache is busy: private
    assert b_priv and b is not a
    assert a.alive()
    fresh_cache.release(b, b_priv)
    assert not b.alive()
    c, c_priv = fresh_cache.acquire(2)  # the same count: shared
    assert c is a and not c_priv
    fresh_cache.release(a, False)
    fresh_cache.release(c, False)
    d, d_priv = fresh_cache.acquire(3)  # no users left: rebuilt
    assert not d_priv and d is not a and not a.alive()
    fresh_cache.release(d, False)
    fresh_cache.close()
    assert not d.alive()
    assert reader.MpPoolCache()._pool is None  # another cache shares nothing


def test_feed_worker_loads_no_torch():
    """`python -m mfcc_tpu_torch.io.feed_worker` (a ping and its reply)
    imports no torch module: the io package's exports are lazy."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-X", "importtime", "-m", "mfcc_tpu_torch.io.feed_worker"],
                         input='{"op": "ping", "id": 5}\n', env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == '{"id": 5, "pong": true}'
    loaded = [line.rsplit("|", 1)[-1].strip() for line in res.stderr.splitlines() if "|" in line]
    assert "mfcc_tpu_torch.io.wav" in loaded and "numpy" in loaded
    assert not [m for m in loaded if m.split(".")[0] in ("torch", "jax", "mfcc_tpu")]


def _members(path) -> dict:
    """An npz's members' bytes (the arrays; the zip's timestamps aside)."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@needs_native
def test_cli_feed_mp_writes_the_direct_feeds_shards(corpus, tmp_path, caplog):
    caplog.set_level(logging.INFO)
    common = [*corpus, "--config", "classic13_deltas", "--device", "cpu", "--batch-size", "4",
              "--max-len-s", "4.0", "--threads", "2"]
    assert tmain(["extract", *common, "-o", str(tmp_path / "mp"), "--feed", "mp"]) == 0
    assert tmain(["extract", *common, "-o", str(tmp_path / "direct"), "--feed", "direct"]) == 0
    caplog.clear()
    assert tmain(["extract", *common, "-o", str(tmp_path / "auto")]) == 0
    assert "--feed auto: the multi-process feed" in caplog.text
    shards = sorted(p.name for p in (tmp_path / "direct").glob("h0-*.npz"))
    assert len(shards) > 3 and any("long" in s for s in shards)
    for out in ("mp", "auto"):
        assert sorted(p.name for p in (tmp_path / out).glob("h0-*.npz")) == shards
        for s in shards:
            assert _members(tmp_path / out / s) == _members(tmp_path / "direct" / s)
    # a resume through the mp feed's header-only planning pass decodes nothing
    caplog.clear()
    assert tmain(["extract", *common, "-o", str(tmp_path / "mp"), "--feed", "mp"]) == 0
    assert "already extracted" in caplog.text
