"""Feed worker process of the multi-process feed: decodes wav files straight
into shared-memory batch slabs on command. The port of
`mfcc_tpu/io/feed_worker.py`.

Run as `python -m mfcc_tpu_torch.io.feed_worker`; the parent
(`io/reader.py::_MpPool`) speaks newline-delimited JSON over stdin/stdout:

  → {"op": "decode_chunk", "id": 7, "slab": "/dev/shm/..", "shape": [B, T],
     "dtype": "i16", "blen": 160000, "downmix": "first", "sr": 16000,
     "jobs": [[row, "path", n_expected], ...]}
  ← {"id": 7, "fails": [[row, "error message"], ...]}
  → {"op": "parse_headers", "id": 8, "paths": ["a.wav", ...]}
  ← {"id": 8, "heads": [[sr, n], [0, -1, "error message"], ...]}
  → {"op": "drop_slabs", "id": 9, "names": ["/dev/shm/..", ...]}
  ← {"id": 9, "dropped": true}
  → {"op": "ping", "id": 10}   ← {"id": 10, "pong": true}
  → {"op": "exit"}   (or EOF)

Rows are flat: a row decodes at slab[row, :blen] and its tail past blen is
zeroed, so a recycled slab never leaks stale samples. Slabs are plain files
in /dev/shm, np.memmap'd on first use and cached by (name, shape, dtype).
Workers are plain subprocesses, so there is no `__main__` re-import and no
fork of a threaded parent, and a worker crash is an EOF the parent handles.

A worker loads `io/wav.py` and numpy and nothing else of the port: no torch
(the `io` package's exports are lazy).
"""

from __future__ import annotations

import json
import sys

import numpy as np


def _reply(out, msg: dict) -> None:
    out.write(json.dumps(msg) + "\n")
    out.flush()


def main() -> int:
    from mfcc_tpu_torch.io import wav

    wav._native()  # build / load the C++ decoder once, up front
    slabs: dict[tuple, np.ndarray] = {}
    out = sys.stdout
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        cmd = json.loads(line)
        op = cmd.get("op")
        if op == "exit":
            break
        if op == "ping":
            _reply(out, {"id": cmd.get("id"), "pong": True})
        elif op == "drop_slabs":
            # the parent unlinks these files: release the mappings so the
            # unlinked pages are freed
            names = set(cmd.get("names", []))
            for k in [k for k in slabs if k[0] in names]:
                del slabs[k]
            _reply(out, {"id": cmd.get("id"), "dropped": True})
        elif op == "parse_headers":
            # (sr, n) per path by the one-read parse; errors go back as
            # strings, so the parent keeps its skip / log / stats semantics
            heads = []
            for path in cmd["paths"]:
                try:
                    heads.append(list(wav.parse_file_header(path)))
                except (OSError, ValueError) as e:  # wav.WavError is a ValueError
                    heads.append([0, -1, str(e)])
            _reply(out, {"id": cmd.get("id"), "heads": heads})
        elif op == "decode_chunk":
            _reply(out, {"id": cmd["id"], "fails": _decode_chunk(cmd, slabs, wav)})
        else:
            _reply(out, {"id": cmd.get("id"), "error": f"unknown op {op!r}"})
    return 0


def _decode_chunk(cmd: dict, slabs: dict, wav) -> list:
    """Decode cmd's jobs into their slab rows; returns [[row, message]] of
    the rows that failed (zeroed)."""
    key = (cmd["slab"], tuple(cmd["shape"]), cmd["dtype"])
    slab = slabs.get(key)
    if slab is None:
        dt = np.int16 if cmd["dtype"] == "i16" else np.float32
        slab = slabs[key] = np.memmap(cmd["slab"], dtype=dt, mode="r+", shape=tuple(cmd["shape"]))
    blen, want_sr = cmd["blen"], cmd["sr"]
    downmix = cmd.get("downmix", "first")
    fails = []
    for row, path, want_n in cmd["jobs"]:
        try:
            fsr, n_valid = wav.decode_file_into(path, slab[row, :blen], downmix=downmix)
            if fsr != want_sr or n_valid != want_n:
                # the file changed between the parent's header parse and
                # this decode: fail the row rather than give features of a
                # stale length or rate
                slab[row, :blen] = 0
                fails.append([row, (f"file changed since header parse: decoded {n_valid} "
                                    f"samples at {fsr} Hz, header said {want_n} at {want_sr}")])
        except (OSError, ValueError, RuntimeError) as e:  # wav.WavError is a ValueError
            slab[row, :blen] = 0
            fails.append([row, str(e)])
        slab[row, blen:] = 0  # the tail beyond the bucket span
    return fails


if __name__ == "__main__":
    sys.exit(main())
