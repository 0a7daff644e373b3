"""`python -m mfcc_tpu_torch.cli serve --device cpu` ≡ the JAX package's
`python -m mfcc_tpu.cli serve` on the same request lines, on the CPU.

The same events in the same order (opened, error and done events equal;
each session's frames within the family's gate, at the frames' places in
the stream), on both wires: jsonl (b64 and float-list pushes, b64,
b64-batched and list emits) and binary (framed raw PCM and features);
`--emit list` refused on binary; a framing error flushes; an empty push
is a no-op and a partial length prefix a truncation; backpressure drains
and retries (the port catches `BufferFullError`, the reference matches a
message); an explicit poll drains; EOF and SIGTERM flush; global CMVN
stats. Where the port differs from the reference on purpose: frames_batch
metas are split so no outbound header reaches the reader's 1 MiB cap
(`cli.main.chunk_metas`), and `--device cuda` without a card, or a float64
config on the card, exits 2 before any event.
"""

import base64
import importlib
import json
import os
import pathlib
import signal
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mfcc_tpu.cli import main as jmain
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.ops import chain
from tests.test_torch_longform import _assert_close

tcli = importlib.import_module("mfcc_tpu_torch.cli.main")
REPO = pathlib.Path(__file__).resolve().parents[1]


class _BinIn:
    """A binary stdin (the server reads getattr(stdin, "buffer", stdin))."""

    def __init__(self, data: bytes):
        import io

        self.buffer = io.BytesIO(data)

    def __iter__(self):
        return iter(())


def _msg(obj, payload=b"") -> bytes:
    head = json.dumps(obj).encode()
    return struct.pack("<I", len(head)) + head + struct.pack("<I", len(payload)) + payload


def _parse_framed(raw: bytes) -> list:
    out, off = [], 0
    while off < len(raw):
        (hlen,) = struct.unpack_from("<I", raw, off)
        head = json.loads(raw[off + 4 : off + 4 + hlen].decode())
        off += 4 + hlen
        (plen,) = struct.unpack_from("<I", raw, off)
        out.append((head, raw[off + 4 : off + 4 + plen]))
        off += 4 + plen
    return out


def _serve(port: bool, monkeypatch, capsys, lines, *argv) -> tuple[int, list]:
    """One jsonl run of either package's serve: (rc, [(event, payload)])."""
    import io

    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(line + "\n" for line in lines)))
    rc = tcli.main(["serve", *argv, "--device", "cpu"]) if port else jmain(["serve", *argv])
    out = capsys.readouterr().out
    events = []
    for line in out.splitlines():
        if line.strip():
            ev = json.loads(line)
            events.append((ev, base64.b64decode(ev["data"]) if "data" in ev else b""))
    return rc, events


def _serve_bin(port: bool, monkeypatch, capsysbinary, raw: bytes, *argv) -> tuple[int, list]:
    monkeypatch.setattr(sys, "stdin", _BinIn(raw))
    rc = (tcli.main(["serve", *argv, "--wire", "binary", "--device", "cpu"]) if port
          else jmain(["serve", *argv, "--wire", "binary"]))
    return rc, _parse_framed(capsysbinary.readouterr().out)


def _frames(events) -> dict:
    """Each session's concatenated frames, from frames and frames_batch
    events (b64 data, raw payloads or lists)."""
    rows = {}
    for ev, payload in events:
        if ev.get("event") == "frames":
            a = (np.asarray(ev["frames"], np.float32) if "frames" in ev
                 else np.frombuffer(payload, "<f4").reshape(ev["n"], ev["dim"]))
            rows.setdefault(ev["sid"], []).append(a)
        elif ev.get("event") == "frames_batch":
            a, off = np.frombuffer(payload, "<f4"), 0
            for m in ev["streams"]:
                k = m["n"] * m["dim"]
                rows.setdefault(m["sid"], []).append(a[off : off + k].reshape(m["n"], m["dim"]))
                off += k
    return {sid: np.concatenate(r) for sid, r in rows.items()}


def _assert_same_events(cfg, mine, theirs) -> None:
    """The events other than frames equal and in the same order (the final
    stats by its keys and session and frame counts, whose poll counts
    depend on the drain timing); every session's frames within the gate,
    and each session's frames before its done event."""
    def skeleton(events):
        out = []
        for ev, _ in events:
            kind = ev.get("event")
            if kind == "stats":
                out.append(("stats", sorted(ev), ev["sessions_opened"], ev["sessions_finished"],
                            ev["frames_emitted"]))
            elif kind not in ("frames", "frames_batch"):
                out.append(tuple(sorted(ev.items())))
        return out

    assert skeleton(mine) == skeleton(theirs)
    got, want = _frames(mine), _frames(theirs)
    assert sorted(got) == sorted(want)
    for sid in want:
        assert got[sid].shape == want[sid].shape
        _assert_close(cfg, got[sid], want[sid])
    for events in (mine, theirs):
        last_frames, done_at = {}, {}
        for i, (ev, _) in enumerate(events):
            sids = ([ev["sid"]] if ev.get("event") == "frames"
                    else [m["sid"] for m in ev.get("streams", [])])
            for sid in sids:
                last_frames[sid] = i
            if ev.get("event") == "done":
                done_at[ev["sid"]] = i
        assert all(last_frames[s] < done_at[s] for s in last_frames if s in done_at)


def _two_sessions(seed=77):
    g = np.random.default_rng(seed)
    return (g.standard_normal(9000) * 3000).astype(np.int16), (g.standard_normal(4777) * 2000).astype(np.int16)


def _b64(x) -> str:
    return base64.b64encode(x.tobytes()).decode()


@pytest.mark.parametrize("emit", ["b64", "b64-batched", "list"])
def test_serve_jsonl_matches_reference(emit, monkeypatch, capsys):
    """Two interleaved sessions (pcm16 b64 and float sample lists) on the
    jsonl wire, each emit mode; the frames also within the gate of the
    offline chain."""
    x0, x1 = _two_sessions()
    lines = [
        json.dumps({"op": "open", "id": "utt-a"}),
        json.dumps({"op": "open"}),
        json.dumps({"op": "push", "sid": 0, "pcm16": _b64(x0)}),
        json.dumps({"op": "push", "sid": 1, "samples": x1[:3000].astype(float).tolist()}),
        json.dumps({"op": "end", "sid": 0}),
        json.dumps({"op": "push", "sid": 1, "samples": x1[3000:].astype(float).tolist()}),
        json.dumps({"op": "end", "sid": 1}),
    ]
    argv = ("--config", "classic13_deltas", "--streams", "4", "--frames-per-block", "8", "--emit", emit)
    rc, mine = _serve(True, monkeypatch, capsys, lines, *argv)
    rc_ref, theirs = _serve(False, monkeypatch, capsys, lines, *argv)
    assert rc == rc_ref == 0
    cfg = T_CONFIGS["classic13_deltas"]
    _assert_same_events(cfg, mine, theirs)
    got = _frames(mine)
    for sid, x in ((0, x0), (1, x1)):
        want = chain.extract_single(torch.as_tensor(x.astype(np.float32)), cfg, device="cpu").numpy()
        assert got[sid].shape == want.shape
        if emit != "list":  # list rounds to 6 decimals
            _assert_close(cfg, got[sid], want)
    kinds = [ev["event"] for ev, _ in mine]
    assert ("frames" in kinds) == (emit != "b64-batched") and ("frames_batch" in kinds) == (emit == "b64-batched")
    final = mine[-1][0]
    assert final["event"] == "stats" and final["frames_emitted"] == got[0].shape[0] + got[1].shape[0]
    assert 1 <= final["poll_rounds"] < len(lines)  # drains at burst ends, not a line


def test_serve_binary_wire_matches_reference(monkeypatch, capsysbinary):
    x0, x1 = _two_sessions(113)
    raw = b"".join([
        _msg({"op": "open", "id": "bin-a"}), _msg({"op": "open"}),
        _msg({"op": "push", "sid": 0}, x0.tobytes()),
        _msg({"op": "push", "sid": 1}, x1[:3000].tobytes()),
        _msg({"op": "end", "sid": 0}),
        _msg({"op": "push", "sid": 1}, x1[3000:].tobytes()),
        _msg({"op": "end", "sid": 1}),
    ])
    argv = ("--config", "classic13_deltas", "--streams", "4", "--frames-per-block", "8")
    for emit in ("b64", "b64-batched"):
        rc, mine = _serve_bin(True, monkeypatch, capsysbinary, raw, *argv, "--emit", emit)
        rc_ref, theirs = _serve_bin(False, monkeypatch, capsysbinary, raw, *argv, "--emit", emit)
        assert rc == rc_ref == 0
        _assert_same_events(T_CONFIGS["classic13_deltas"], mine, theirs)


def test_serve_binary_refuses_list_emit(monkeypatch, capsysbinary):
    argv = ("--config", "classic13", "--streams", "2", "--emit", "list")
    assert _serve_bin(True, monkeypatch, capsysbinary, b"", *argv) == (2, [])
    assert _serve_bin(False, monkeypatch, capsysbinary, b"", *argv) == (2, [])


@pytest.mark.parametrize("tail", ["oversized_header", "partial_prefix"])
def test_serve_binary_framing_errors_flush(tail, monkeypatch, capsysbinary):
    """An absurd header length, or EOF after 2 of 4 length-prefix bytes, is
    reported and flushes the open streams like EOF; an empty push is a
    0-sample no-op."""
    x = (np.random.default_rng(127).standard_normal(4000) * 3000).astype(np.int16)
    raw = b"".join([_msg({"op": "open"}), _msg({"op": "push", "sid": 0}, b""),
                    _msg({"op": "push", "sid": 0}, x.tobytes())])
    raw += struct.pack("<I", 1 << 24) + b"garbage" if tail == "oversized_header" else b"\x07\x00"
    argv = ("--config", "classic13", "--streams", "2")
    rc, mine = _serve_bin(True, monkeypatch, capsysbinary, raw, *argv)
    rc_ref, theirs = _serve_bin(False, monkeypatch, capsysbinary, raw, *argv)
    assert rc == rc_ref == 0
    _assert_same_events(T_CONFIGS["classic13"], mine, theirs)
    errors = [ev["msg"] for ev, _ in mine if ev.get("event") == "error"]
    assert len(errors) == 1 and ("1 MiB" in errors[0] if tail == "oversized_header"
                                 else "length prefix" in errors[0])
    assert _frames(mine)[0].shape[0] == T_CONFIGS["classic13"].num_frames(4000)


def test_serve_backpressure_drains_and_retries(monkeypatch, capsys):
    """A pipelined push run over max_buffer_s: the server drains and
    retries the push (the port by catching BufferFullError), so no audio is
    dropped and no error event appears."""
    import functools

    import mfcc_tpu.pipeline as jpipeline
    import mfcc_tpu_torch.pipeline as tpipeline

    monkeypatch.setattr(tpipeline, "MultiStreamExtractor",
                        functools.partial(tpipeline.MultiStreamExtractor, max_buffer_s=0.5))
    monkeypatch.setattr(jpipeline, "MultiStreamExtractor",
                        functools.partial(jpipeline.MultiStreamExtractor, max_buffer_s=0.5))
    x = (np.random.default_rng(95).standard_normal(16000) * 3000).astype(np.int16)
    lines = ([json.dumps({"op": "open"})]
             + [json.dumps({"op": "push", "sid": 0, "pcm16": _b64(c)}) for c in np.array_split(x, 8)]
             + [json.dumps({"op": "end", "sid": 0})])
    argv = ("--config", "classic13", "--streams", "2", "--frames-per-block", "8")
    rc, mine = _serve(True, monkeypatch, capsys, lines, *argv)
    rc_ref, theirs = _serve(False, monkeypatch, capsys, lines, *argv)
    assert rc == rc_ref == 0
    assert not any(ev.get("event") == "error" for ev, _ in mine)
    _assert_same_events(T_CONFIGS["classic13"], mine, theirs)
    assert _frames(mine)[0].shape[0] == T_CONFIGS["classic13"].num_frames(16000)


def test_serve_explicit_poll_and_eof_flush_with_errors(monkeypatch, capsys):
    """Explicit polls drain mid-burst; bad requests give the reference's
    error events and the loop goes on; a session left open at EOF is ended
    and drained."""
    x = (np.random.default_rng(78).standard_normal(6400) * 3000).astype(np.int16)
    lines = [
        json.dumps({"op": "open"}), json.dumps({"op": "nope"}),
        json.dumps({"op": "push", "sid": 99, "samples": [0.0]}), "not json at all",
        json.dumps({"op": "push", "sid": 0, "pcm16": _b64(x)}),
        json.dumps({"op": "poll"}), json.dumps({"op": "poll"}),
        json.dumps({"op": "close", "sid": 7}),
    ]  # no end: EOF flushes
    argv = ("--config", "classic13", "--streams", "2", "--frames-per-block", "8")
    rc, mine = _serve(True, monkeypatch, capsys, lines, *argv)
    rc_ref, theirs = _serve(False, monkeypatch, capsys, lines, *argv)
    assert rc == rc_ref == 0
    _assert_same_events(T_CONFIGS["classic13"], mine, theirs)
    assert len([ev for ev, _ in mine if ev.get("event") == "error"]) == 4
    assert mine[-1][0]["poll_rounds"] >= 3


def test_serve_with_global_cmvn_stats(monkeypatch, capsys, tmp_path):
    from mfcc_tpu_torch.parallel import CmvnAccumulator

    cfg = T_CONFIGS["classic13_deltas_gcmvn"]
    g = np.random.default_rng(91)
    x = (g.standard_normal(7000) * 3000).astype(np.int16)
    acc = CmvnAccumulator(cfg.feat_dim)
    for u in (x, (g.standard_normal(5000) * 2000).astype(np.int16)):
        f = chain.extract_single(torch.as_tensor(u.astype(np.float32)), cfg, device="cpu").double().numpy()
        acc.add(f.sum(0), (f**2).sum(0), f.shape[0])
    acc.save(tmp_path / "m.npz")
    lines = [json.dumps({"op": "open"}), json.dumps({"op": "push", "sid": 0, "pcm16": _b64(x)}),
             json.dumps({"op": "end", "sid": 0})]
    argv = ("--config", "classic13_deltas_gcmvn", "--cmvn-stats", str(tmp_path / "m.npz"))
    rc, mine = _serve(True, monkeypatch, capsys, lines, *argv)
    rc_ref, theirs = _serve(False, monkeypatch, capsys, lines, *argv)
    assert rc == rc_ref == 0
    np.testing.assert_allclose(_frames(mine)[0], _frames(theirs)[0], atol=5e-4, rtol=1e-4)
    assert _serve(True, monkeypatch, capsys, [], "--config", "classic13_deltas_gcmvn") == (2, [])


def test_frames_batch_metas_are_split_under_the_header_cap(monkeypatch, capsysbinary):
    """`chunk_metas` keeps every frames_batch header under the cap: 40,000
    metas, whose one header would be over 1 MiB, split into runs each under
    it; a serve run with the cap at 150 bytes emits several frames_batch
    events a round, each header under 150 bytes, and the same frames."""
    metas = [{"sid": i, "n": 16, "dim": 39} for i in range(40_000)]
    assert len(json.dumps({"event": "frames_batch", "streams": metas})) > tcli.WIRE_HEADER_CAP
    runs = tcli.chunk_metas(metas, tcli.WIRE_HEADER_CAP)
    assert len(runs) > 1 and [m for r in runs for m in r] == metas
    assert all(len(json.dumps({"event": "frames_batch", "streams": r})) <= tcli.WIRE_HEADER_CAP
               for r in runs)
    g = np.random.default_rng(5)
    xs = [(g.standard_normal(5000) * 3000).astype(np.int16) for _ in range(4)]
    raw = b"".join([_msg({"op": "open"}) for _ in xs]
                   + [_msg({"op": "push", "sid": i}, x.tobytes()) for i, x in enumerate(xs)]
                   + [_msg({"op": "end", "sid": i}) for i in range(4)])
    argv = ("--config", "classic13", "--streams", "4", "--emit", "b64-batched")
    _, whole = _serve_bin(True, monkeypatch, capsysbinary, raw, *argv)
    monkeypatch.setattr(tcli, "WIRE_HEADER_CAP", 150)
    _, split = _serve_bin(True, monkeypatch, capsysbinary, raw, *argv)
    batches = [ev for ev, _ in split if ev.get("event") == "frames_batch"]
    assert len(batches) > len([ev for ev, _ in whole if ev.get("event") == "frames_batch"])
    assert all(len(json.dumps(ev)) <= 150 for ev in batches)
    got, want = _frames(split), _frames(whole)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    assert all(np.array_equal(got[s], want[s]) for s in want)


def test_serve_refuses_before_any_event(monkeypatch, capsys):
    """--device cuda (the default) without a card, and a float64 config on
    the card, exit 2 and print no event; 60,000 filters, refused before
    (over the packed mel table's filter field), serve a session on the CPU."""
    lines = [json.dumps({"op": "open"})]
    monkeypatch.setattr(sys, "stdin", __import__("io").StringIO(lines[0] + "\n"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["serve", "--config", "classic13"]) == 2
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(sys, "stdin", __import__("io").StringIO(lines[0] + "\n"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcli.main(["serve", "--config", "classic13", "--set", "dtype=float64"]) == 2
    assert capsys.readouterr().out == ""
    rc, events = _serve(True, monkeypatch, capsys, lines, "--config", "classic13",
                        "--set", "n_mels=60000")
    assert rc == 0 and [ev["event"] for ev, _ in events][:1] == ["opened"]
    rc, events = _serve(True, monkeypatch, capsys, lines, "--config", "whisper80")
    assert (rc, events) == (2, [])


def test_serve_sigterm_flushes(tmp_path):
    """SIGTERM flushes the open streams (tail frames, done, a final stats
    event) and exits 0."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "mfcc_tpu_torch.cli", "serve", "--config", "classic13",
         "--streams", "2", "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env, cwd=REPO,
    )
    try:
        x = (np.random.default_rng(3).standard_normal(6000) * 2000).astype(np.int16)
        proc.stdin.write(json.dumps({"op": "open"}) + "\n")
        proc.stdin.write(json.dumps({"op": "push", "sid": 0, "pcm16": _b64(x)}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["event"] == "opened"
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0
    events = [json.loads(line) for line in out.splitlines() if line.strip()]
    kinds = [e.get("event") for e in events]
    assert "frames" in kinds and "done" in kinds and kinds[-1] == "stats"
    assert sum(e["n"] for e in events if e.get("event") == "frames") == T_CONFIGS["classic13"].num_frames(6000)
