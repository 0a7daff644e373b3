"""The port's serving pool (`mfcc_tpu_torch.pipeline.MultiStreamExtractor`)
≡ the JAX package's (`mfcc_tpu.pipeline.serving`), on the CPU.

Every stream's concatenated poll() output equals its own single-stream
`StreamingExtractor` run within 1e-5 here (bitwise is the card's claim,
tests/test_torch_gpu.py and chip_smoke.py phase 23) and the JAX pool's at
the family's gate, under interleaved sessions: the lifecycle, slot reuse,
`end_all`, `close`, the reference's fuzz, global CMVN, resampled sessions,
and backpressure, which raises a dedicated `BufferFullError` (a
RuntimeError) where the reference raises a RuntimeError matched by its
message. A round launches the front-end's block form once over the streams
with a block ready and the tail at most twice.
"""

import numpy as np
import pytest

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.pipeline.serving import MultiStreamExtractor as JPool
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend, tail
from mfcc_tpu_torch.pipeline import BufferFullError, MultiStreamExtractor, StreamingExtractor
from tests.test_torch_longform import _assert_close

POOL_ATOL = 1e-5  # pool vs its own single streams on the CPU: the same plain ops, rows apart


def _pool(cfg, n, **kw):
    return MultiStreamExtractor(cfg, n, device="cpu", **kw)


def _single(cfg, x, K, **kw) -> np.ndarray:
    ex = StreamingExtractor(cfg, frames_per_block=K, device="cpu", **kw)
    return np.concatenate([ex.push(x), ex.flush()])


def _chunked(x, r, lo=1, hi=2000) -> list:
    out, pos = [], 0
    while pos < len(x):
        c = int(min(len(x) - pos, r.integers(lo, hi)))
        out.append(x[pos : pos + c])
        pos += c
    return out


def _interleave(pool, feeds: list) -> dict:
    """The reference test's schedule: one chunk a stream a turn, a poll
    every other turn, end after the last chunk, then poll until idle."""
    sids = [pool.open() for _ in feeds]
    got = {s: [] for s in sids}
    feeds = [list(f) for f in feeds]
    turn = 0
    while any(feeds):
        for i, f in enumerate(feeds):
            if f:
                pool.push(sids[i], f.pop(0))
                if not f:
                    pool.end(sids[i])
        if turn % 2 == 0:
            for s, v in pool.poll().items():
                got[s].append(v)
        turn += 1
    while pool.n_active:
        for s, v in pool.poll().items():
            got[s].append(v)
    assert all(pool.done(s) for s in sids)
    return {i: np.concatenate(got[s]) for i, s in enumerate(sids)}


@pytest.mark.parametrize("name", ["classic13_deltas", "logmel80", "kaldi_plp", "mfcc39_48k"])
def test_pool_matches_reference_pool_and_single_streams(name):
    tcfg, jcfg = T_CONFIGS[name], J_CONFIGS[name]
    sr = tcfg.input_sample_rate or tcfg.sample_rate
    g = np.random.default_rng(123)
    xs = [(g.standard_normal(int(n * sr / 16000)) * 3000).astype(np.float32)
          for n in (16373, 7001, 399, 23999, 16000)]
    feeds = [_chunked(x, np.random.default_rng(5 + i)) for i, x in enumerate(xs)]
    got = _interleave(_pool(tcfg, len(xs), frames_per_block=16), feeds)
    want = _interleave(JPool(jcfg, len(xs), frames_per_block=16), feeds)
    for i, x in enumerate(xs):
        assert got[i].shape == want[i].shape == (tcfg.num_frames(-(-len(x) * 16000 // sr)),
                                                 tcfg.feat_dim)
        _assert_close(tcfg, got[i], want[i])
        np.testing.assert_allclose(got[i], _single(tcfg, x, 16), rtol=0, atol=POOL_ATOL)


def test_lone_stream_and_counts():
    cfg = T_CONFIGS["classic13_deltas"]
    x = np.random.default_rng(1).standard_normal(12345).astype(np.float32)
    pool = _pool(cfg, 4, frames_per_block=32)
    sid = pool.open()
    pool.push(sid, x)
    pool.end(sid)
    out = pool.poll()[sid]
    np.testing.assert_allclose(out, _single(cfg, x, 32), rtol=0, atol=POOL_ATOL)
    s = pool.stats
    assert s["sessions_opened"] == s["sessions_finished"] == 1 and s["poll_rounds"] == 1
    assert s["frames_emitted"] == out.shape[0] == cfg.num_frames(12345)
    assert s["base_dispatches"] == -(-out.shape[0] // 32) and 1 <= s["fin_dispatches"] <= 2 * s["base_dispatches"]


def test_slot_lifecycle_and_reuse():
    cfg = T_CONFIGS["classic13"]
    pool = _pool(cfg, 2, frames_per_block=8)
    a, b = pool.open(), pool.open()
    with pytest.raises(RuntimeError, match="in use"):
        pool.open()
    pool.push(a, np.random.default_rng(2).standard_normal(4000).astype(np.float32))
    pool.end(a)
    out = pool.poll()
    assert a in out and out[a].shape[0] == cfg.num_frames(4000)
    assert pool.done(a) and not pool.done(b)
    c = pool.open()  # the freed slot, a new sid
    assert c not in (a, b) and pool.n_active == 2
    pool.close(b)
    assert pool.done(b) and pool.n_active == 1
    with pytest.raises(KeyError, match="not open"):
        pool.push(b, np.zeros(10, np.float32))
    x = np.random.default_rng(3).standard_normal(5000).astype(np.float32)
    pool.push(c, x)
    pool.end_all()
    out = pool.poll()
    assert pool.done(c) and pool.n_active == 0
    np.testing.assert_allclose(out[c], _single(cfg, x, 8), rtol=0, atol=POOL_ATOL)


def test_empty_stream_push_after_end_and_idle_poll():
    cfg = T_CONFIGS["classic13_deltas"]
    pool = _pool(cfg, 2)
    sid = pool.open()
    assert pool.poll() == {}
    pool.end(sid)
    with pytest.raises(RuntimeError, match="ended"):
        pool.push(sid, np.zeros(10, np.float32))
    with pytest.raises(RuntimeError, match="ended"):
        pool.end(sid)
    out = pool.poll()
    assert out[sid].shape == (0, cfg.feat_dim) and pool.done(sid)
    with pytest.raises(ValueError, match="n_streams"):
        _pool(cfg, 0)


def test_lifecycle_fuzz():
    """The reference's fuzz: random arrivals, pushes, ends and closes over
    many rounds with slot churn; every finished stream equals its own
    single-stream run."""
    cfg = T_CONFIGS["classic13_deltas"]
    K = 8
    r = np.random.default_rng(31)
    pool = _pool(cfg, 3, frames_per_block=K)
    live, finished, spawned = {}, {}, 0
    while spawned < 12 or live:
        if spawned < 12 and pool.n_active < 3 and r.random() < 0.6:
            live[pool.open()] = {"chunks": [], "got": [], "ended": False}
            spawned += 1
        for sid, st in list(live.items()):
            if st["ended"]:
                continue
            act = r.random()
            if act < 0.55:
                c = r.standard_normal(int(r.integers(1, 4000))).astype(np.float32)
                st["chunks"].append(c)
                pool.push(sid, c)
            elif act < 0.75:
                pool.end(sid)
                st["ended"] = True
            elif act < 0.80 and not st["chunks"]:
                pool.close(sid)
                del live[sid]
        for sid, v in pool.poll().items():
            if sid in live:
                live[sid]["got"].append(v)
        for sid in [s for s in live if pool.done(s)]:
            finished[sid] = live.pop(sid)
    assert len(finished) >= 8
    for sid, st in finished.items():
        got = np.concatenate(st["got"]) if st["got"] else np.zeros((0, cfg.feat_dim), np.float32)
        x = np.concatenate(st["chunks"]) if st["chunks"] else np.zeros(0, np.float32)
        want = _single(cfg, x, K)
        assert got.shape == want.shape, sid
        np.testing.assert_allclose(got, want, rtol=0, atol=POOL_ATOL)


def test_global_cmvn_moments_match_reference():
    tcfg, jcfg = T_CONFIGS["classic13_deltas_gcmvn"], J_CONFIGS["classic13_deltas_gcmvn"]
    x = np.random.default_rng(9).standard_normal(16000).astype(np.float32)
    raw = _single(tcfg.replace(cmvn="off"), x, 16).astype(np.float64)
    moments = (raw.sum(0), (raw**2).sum(0), float(raw.shape[0]))
    pools = [_pool(tcfg, 2, cmvn_moments=moments), JPool(jcfg, 2, cmvn_moments=moments)]
    outs = []
    for pool in pools:
        sid = pool.open()
        pool.push(sid, x)
        pool.end(sid)
        outs.append(pool.poll()[sid])
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(outs[0], _single(tcfg, x, 16, cmvn_moments=moments), rtol=0,
                               atol=POOL_ATOL)
    with pytest.raises(ValueError, match="moments"):
        _pool(tcfg, 2)


def test_backpressure_raises_buffer_full_error():
    """A session that pushes without polling hits max_buffer_s: the port
    raises BufferFullError, a RuntimeError, with the reference's message;
    polling drains and the push goes through."""
    cfg = T_CONFIGS["classic13"]
    pool = _pool(cfg, 1, frames_per_block=8, max_buffer_s=0.2)  # 3,200 samples
    ref = JPool(J_CONFIGS["classic13"], 1, frames_per_block=8, max_buffer_s=0.2)
    sid, rsid = pool.open(), ref.open()
    pool.push(sid, np.zeros(3000, np.float32))
    ref.push(rsid, np.zeros(3000, np.float32))
    with pytest.raises(BufferFullError, match="buffered ahead of poll") as mine:
        pool.push(sid, np.zeros(500, np.float32))
    with pytest.raises(RuntimeError) as theirs:
        ref.push(rsid, np.zeros(500, np.float32))
    assert isinstance(mine.value, RuntimeError) and str(mine.value) == str(theirs.value)
    pool.poll()  # drains complete K = 8 blocks (1,280 samples each)
    pool.push(sid, np.zeros(500, np.float32))
    unlimited = _pool(cfg, 1, max_buffer_s=None)
    unlimited.push(unlimited.open(), np.zeros(200_000, np.float32))


def test_a_round_launches_the_block_once_over_the_ready_streams(monkeypatch):
    """Per round: one block launch whose rows are exactly the streams with a
    block ready (none for idle slots), and at most two tail launches, one a
    window width."""
    calls = []
    real_block, real_tail = frontend.logmel_block, tail.feature_tail
    monkeypatch.setattr(frontend, "logmel_block",
                        lambda rows, valid, cfg, consts=None: calls.append(("block", rows.shape[0]))
                        or real_block(rows, valid, cfg, consts))
    monkeypatch.setattr(tail, "feature_tail",
                        lambda p, n, cfg, consts=None, out=None: calls.append(("tail", tuple(p.shape[:2])))
                        or real_tail(p, n, cfg, consts, out=out))
    cfg = T_CONFIGS["classic13_deltas"]
    pool = _pool(cfg, 8, frames_per_block=16)
    real_round, rounds = pool._engine.round, []

    def counted(entries):
        ready = sum(s.base_need() is not None for _, _, s in entries)
        before = len(calls)
        res = real_round(entries)
        rounds.append((ready, calls[before:], res))
        return res

    monkeypatch.setattr(pool._engine, "round", counted)
    g = np.random.default_rng(4)
    sids = [pool.open() for _ in range(5)]  # 3 slots stay idle
    for step in range(6):
        for i, s in enumerate(sids[: 2 + step % 4]):
            pool.push(s, (g.standard_normal(2560) * 1000).astype(np.float32))
        pool.poll()
    pool.end_all()
    while pool.n_active:
        pool.poll()
    for ready, made, res in rounds:
        blocks = [n for k, n in made if k == "block"]
        assert blocks == ([ready] if ready else [])
        tails = [shape for k, shape in made if k == "tail"]
        assert len(blocks) == res.base_launches <= 1 and len(tails) == res.fin_launches <= 2
        assert len({w for _, w in tails}) == len(tails)  # one a width
    assert sum(res.base_launches for _, _, res in rounds) >= 6
    assert any(n > 1 for k, n in calls if k == "block") and all(n <= 5 for k, n in calls if k == "block")
