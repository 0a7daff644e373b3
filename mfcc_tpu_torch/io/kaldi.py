"""Kaldi ark/scp feature output (the port of `mfcc_tpu/io/kaldi.py`, the
same bytes) — the other dominant ASR-toolchain interchange format next to
HTK (io/htk.py). The reference family's users
feed features into Kaldi/ESPnet/k2 recipes as binary archives; this writes
them directly so no conversion step is needed.

Binary archive layout (Kaldi src/util/kaldi-holder-inl.h, kaldi-matrix.cc —
public format, re-implemented from the spec):

    <key> ' ' \\0 'B'  'F' 'M' ' '  \\4 <int32 rows>  \\4 <int32 cols>  <f32 data>

per utterance: a whitespace-free UTF-8 key, one space, the two-byte binary
marker, the "FM " float-matrix token, two \\4-prefixed little-endian int32
dimensions, then rows*cols little-endian float32, row-major. The companion
.scp line is `<key> <ark_path>:<offset>` with offset pointing at the binary
marker (the byte after the key's space), exactly where Kaldi's
ReadScriptFile seeks to.

Column layout: Kaldi's own MFCC puts C0/energy FIRST in each static/Δ/ΔΔ
block (use_energy=true, feats.scp convention), which is also this
extractor's native layout (SURVEY.md Appendix B step 9) — features are
written unpermuted, unlike HTK's energy-last roll.

Keys: Kaldi tokens cannot contain whitespace; `ark_key` maps an utterance
id (usually a wav path) to a key by replacing whitespace runs with '_'.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

__all__ = ["ArkWriter", "ark_key", "read_ark", "read_scp"]

_BINARY = b"\0B"
_FLOAT_MATRIX = b"FM "


def ark_key(utt_id) -> str:
    """Whitespace-free Kaldi key for an utterance id.

    Ids without whitespace (the normal case: file paths) pass through
    unchanged, so distinct paths keep distinct keys. When whitespace is
    replaced, a short id-hash suffix disambiguates — otherwise 'u 1.wav'
    and 'u_1.wav' would collide on one key (same trick as the HTK
    writer's filename hashing, writer.py _write_htk_files)."""
    import hashlib

    sid = str(utt_id)
    key = "_".join(sid.split())
    if key == sid:
        return key
    return f"{key or 'utt'}-{hashlib.sha256(sid.encode()).hexdigest()[:8]}"


def _matrix_header(rows: int, cols: int) -> bytes:
    """Kaldi binary float-matrix header: the ONE definition of the wire
    layout (ArkWriter.add streams the row data after it zero-copy)."""
    return (
        _BINARY + _FLOAT_MATRIX
        + b"\x04" + struct.pack("<i", rows)
        + b"\x04" + struct.pack("<i", cols)
    )


def _matrix_bytes(feat: np.ndarray) -> bytes:
    feat = np.ascontiguousarray(np.asarray(feat, dtype="<f4"))
    if feat.ndim != 2:
        raise ValueError(f"expected [F, D] features, got shape {feat.shape}")
    return _matrix_header(*feat.shape) + feat.tobytes()


class ArkWriter:
    """Writes `<prefix>.ark` + `<prefix>.scp` (tmp files renamed into place
    on close, so readers never see partial archives). Context manager:

        with ArkWriter(out_dir / "h0-000001") as w:
            w.add("utt1", feat1)
    """

    def __init__(self, prefix):
        self.ark_path = pathlib.Path(str(prefix) + ".ark")
        self.scp_path = pathlib.Path(str(prefix) + ".scp")
        self._ark_tmp = pathlib.Path(str(self.ark_path) + ".tmp")
        self._scp_tmp = pathlib.Path(str(self.scp_path) + ".tmp")
        self._ark = open(self._ark_tmp, "wb")
        self._scp = open(self._scp_tmp, "w", encoding="utf-8")
        self._pos = 0
        self._keys: set[str] = set()

    def add(self, utt_id, feat: np.ndarray) -> str:
        """Append one utterance; returns the key written."""
        key = ark_key(utt_id)
        if key in self._keys:
            raise ValueError(f"duplicate ark key {key!r}")
        self._keys.add(key)
        head = key.encode("utf-8") + b" "
        self._ark.write(head)
        offset = self._pos + len(head)
        # write the matrix header then the row data STRAIGHT from the
        # array buffer — _matrix_bytes' tobytes() copied every matrix a
        # second time, which showed up as the writer binding the
        # integrated e2e pipeline under the kaldi format (E2E_r05)
        feat = np.ascontiguousarray(np.asarray(feat, dtype="<f4"))
        if feat.ndim != 2:
            raise ValueError(f"expected [F, D] features, got {feat.shape}")
        mhead = _matrix_header(*feat.shape)
        self._ark.write(mhead)
        self._ark.write(feat.data)
        self._pos = offset + len(mhead) + feat.nbytes
        # the scp references the FINAL ark path, absolute (Kaldi feats.scp
        # convention; valid after close())
        self._scp.write(f"{key} {self.ark_path.resolve()}:{offset}\n")
        return key

    def close(self) -> None:
        if self._ark.closed:
            return
        self._ark.close()
        self._scp.close()
        self._ark_tmp.rename(self.ark_path)
        self._scp_tmp.rename(self.scp_path)

    def abort(self) -> None:
        """Drop the partial archive (crash/error path)."""
        if not self._ark.closed:
            self._ark.close()
            self._scp.close()
        self._ark_tmp.unlink(missing_ok=True)
        self._scp_tmp.unlink(missing_ok=True)

    def __enter__(self) -> "ArkWriter":
        return self

    def __exit__(self, exc_type, *_) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


def _read_matrix(f, where: str) -> np.ndarray:
    if f.read(2) != _BINARY:
        raise ValueError(f"{where}: not a Kaldi binary entry")
    token = f.read(3)
    if token != _FLOAT_MATRIX:
        raise ValueError(f"{where}: unsupported matrix token {token!r}")
    dims = []
    for _ in range(2):
        if f.read(1) != b"\x04":
            raise ValueError(f"{where}: bad dimension size marker")
        dims.append(struct.unpack("<i", f.read(4))[0])
    rows, cols = dims
    if rows < 0 or cols < 0:
        raise ValueError(f"{where}: bad matrix shape ({rows}, {cols})")
    body = f.read(rows * cols * 4)
    if len(body) != rows * cols * 4:
        raise ValueError(f"{where}: truncated matrix data")
    return np.frombuffer(body, dtype="<f4").reshape(rows, cols).copy()


def read_ark(path) -> dict[str, np.ndarray]:
    """Sequentially read a binary ark -> {key: [F, D] float32}."""
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        while True:
            key_bytes = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    if key_bytes:
                        raise ValueError(f"{path}: trailing garbage after data")
                    return out
                if c == b" ":
                    break
                key_bytes += c
            key = key_bytes.decode("utf-8")
            out[key] = _read_matrix(f, f"{path}:{key}")


def read_scp(path) -> dict[str, np.ndarray]:
    """Random-access read via an scp -> {key: [F, D] float32} (exercises
    the offsets Kaldi's table readers seek to)."""
    out: dict[str, np.ndarray] = {}
    base = pathlib.Path(path).parent
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, loc = line.split(None, 1)
            ark, off = loc.rsplit(":", 1)
            ark_path = pathlib.Path(ark)
            if not ark_path.is_absolute():
                ark_path = base / ark_path
            with open(ark_path, "rb") as a:
                a.seek(int(off))
                out[key] = _read_matrix(a, f"{path}:{key}")
    return out
