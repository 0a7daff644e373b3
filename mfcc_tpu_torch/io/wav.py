"""WAV decode for the port: a numpy decoder and a ctypes binding to the C++
one (`io/csrc/wavdec.cpp`, a copy of the JAX package's), which g++ builds at
first use into `build/` at the root of the checkout.

The port of `mfcc_tpu/io/wav.py`, with the same public names and bytes out.
The build goes to a temporary file renamed into place (`os.replace`), keyed
by the source, the flags and the compiler's version, so processes that build
at once each load a whole library. Without g++ the numpy decoder is used;
`_native()` logs which decoder it chose. Both are host code.

Scaling convention (both paths identical, tested byte-for-byte): samples are
returned as float32 in the *int16 value range* — PCM16 values pass through
raw, other widths are rescaled to it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import pathlib
import struct
import subprocess

import numpy as np

from mfcc_tpu_torch.kernels._build import BUILD_DIR

log = logging.getLogger(__name__)

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc" / "wavdec.cpp"

_DECODE_ERRORS = {
    -1: "truncated file",
    -2: "not a RIFF/WAVE file",
    -3: "missing fmt chunk",
    -4: "unsupported format tag",
    -5: "missing data chunk",
    -6: "unsupported bits per sample",
    -7: "output buffer too small",
    -8: "cannot open/map file",
}


class WavError(ValueError):
    pass


# ---------------------------------------------------------------------------
# C++ fast path
# ---------------------------------------------------------------------------


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("format", ctypes.c_int32),
        ("num_frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
        ("data_size", ctypes.c_int64),
    ]


CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _compiler_version(cxx: str) -> bytes:
    res = subprocess.run([cxx, "--version"], capture_output=True, timeout=60)
    if res.returncode != 0:
        raise FileNotFoundError(f"{cxx} --version failed")
    return res.stdout


def _build_library() -> ctypes.CDLL | None:
    """Compile wavdec.cpp into build/ unless that build exists; ctypes-load
    it. None (and a warning) when no compiler or build works."""
    cxx = os.environ.get("CXX", "g++")
    try:
        key = _CSRC.read_bytes() + " ".join(CXX_FLAGS).encode() + _compiler_version(cxx)
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("no C++ compiler for the wav decoder (%s); using the numpy decoder", e)
        return None
    so = BUILD_DIR / f"wavdec_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *CXX_FLAGS, str(_CSRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic: concurrent builders never load half a file
        except (subprocess.SubprocessError, OSError) as e:
            tmp.unlink(missing_ok=True)
            log.warning("wavdec C++ build failed (%s); using the numpy decoder", e)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:  # pragma: no cover
        log.warning("wavdec load failed (%s); using the numpy decoder", e)
        return None
    lib.wav_decode_f32.restype = ctypes.c_int32
    lib.wav_decode_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(_WavInfo),
    ]
    lib.wav_parse.restype = ctypes.c_int32
    lib.wav_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_WavInfo)]
    lib.wav_parse_prefix.restype = ctypes.c_int32
    lib.wav_parse_prefix.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(_WavInfo),
    ]
    lib.wav_decode_i16.restype = ctypes.c_int32
    lib.wav_decode_i16.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.POINTER(_WavInfo),
    ]
    lib.wav_decode_file.restype = ctypes.c_int32
    lib.wav_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(_WavInfo),
    ]
    lib.wav_parse_file.restype = ctypes.c_int32
    lib.wav_parse_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
    return lib


@functools.lru_cache(maxsize=1)
def _native() -> ctypes.CDLL | None:
    """The C++ decoder, built and loaded once a process; None when it is
    unavailable (the numpy decoder then runs)."""
    lib = _build_library()
    log.info("wav decoder: %s", "C++ (io/csrc/wavdec.cpp)" if lib is not None else "numpy")
    return lib


def _decode_native(data: bytes, downmix: str) -> tuple[int, np.ndarray] | None:
    lib = _native()
    if lib is None:
        return None
    info = _WavInfo()
    rc = lib.wav_parse(data, len(data), ctypes.byref(info))
    if rc != 0:
        raise WavError(_DECODE_ERRORS.get(rc, f"decode error {rc}"))
    out = np.empty(info.num_frames, dtype=np.float32)
    rc = lib.wav_decode_f32(
        data, len(data), 1 if downmix == "mean" else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.shape[0],
        ctypes.byref(info),
    )
    if rc != 0:
        raise WavError(_DECODE_ERRORS.get(rc, f"decode error {rc}"))
    return int(info.sample_rate), out


# ---------------------------------------------------------------------------
# numpy reference path (identical semantics)
# ---------------------------------------------------------------------------


def _decode_numpy(data: bytes, downmix: str) -> tuple[int, np.ndarray]:
    try:
        return _decode_numpy_inner(data, downmix)
    except struct.error as e:
        # struct.error is NOT a ValueError; without this wrap it would
        # escape the decode worker's except clause and kill the thread
        raise WavError(f"truncated file ({e})") from e


def _decode_numpy_inner(data: bytes, downmix: str) -> tuple[int, np.ndarray]:
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file" if len(data) >= 12 else "truncated file")
    pos, fmt = 12, None
    d_off = d_size = 0
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if cid == b"fmt ":
            if body + 16 > len(data):
                raise WavError("truncated file")
            tag, ch, rate, _, _, bits = struct.unpack_from("<HHIIHH", data, body)
            if tag == 0xFFFE:
                (cb,) = struct.unpack_from("<H", data, body + 16)
                if cb < 22:
                    raise WavError("unsupported format tag")
                (tag,) = struct.unpack_from("<H", data, body + 24)
            if tag not in (1, 3) or ch == 0:
                raise WavError("unsupported format tag")
            fmt = (tag, ch, rate, bits)
        elif cid == b"data":
            d_off, d_size = body, min(csize, len(data) - body)
        pos = body + csize + (csize & 1)
    if fmt is None:
        raise WavError("missing fmt chunk")
    if d_off == 0:
        raise WavError("missing data chunk")
    tag, ch, rate, bits = fmt
    raw = data[d_off : d_off + d_size]
    if tag == 1:
        if bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) * 256.0
        elif bits == 16:
            x = np.frombuffer(raw[: len(raw) // 2 * 2], "<i2").astype(np.float32)
        elif bits == 24:
            b = np.frombuffer(raw[: len(raw) // 3 * 3], np.uint8).reshape(-1, 3)
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            v = np.where(v & 0x800000, v | ~0xFFFFFF, v)
            x = v.astype(np.float32) / 256.0
        elif bits == 32:
            x = np.frombuffer(raw[: len(raw) // 4 * 4], "<i4").astype(np.float32) / 65536.0
        else:
            raise WavError("unsupported bits per sample")
    else:
        if bits == 32:
            x = np.frombuffer(raw[: len(raw) // 4 * 4], "<f4").astype(np.float32) * 32768.0
        elif bits == 64:
            x = (np.frombuffer(raw[: len(raw) // 8 * 8], "<f8") * 32768.0).astype(np.float32)
        else:
            raise WavError("unsupported bits per sample")
    n = x.shape[0] // ch
    x = x[: n * ch].reshape(n, ch)
    x = x.mean(axis=1) if (downmix == "mean" and ch > 1) else x[:, 0]
    return int(rate), np.ascontiguousarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def decode_wav_bytes(
    data: bytes, downmix: str = "first", native: bool | None = None
) -> tuple[int, np.ndarray]:
    """bytes → (sample_rate, float32 mono samples in int16 range).

    downmix: "first" (channel 0) or "mean". native=None tries the C++
    decoder and falls back to numpy; True/False force a path.
    """
    if downmix not in ("first", "mean"):
        raise ValueError(f"downmix={downmix!r}")
    if native is not False:
        got = _decode_native(data, downmix)
        if got is not None:
            return got
        if native is True:
            raise RuntimeError("native wav decoder unavailable")
    return _decode_numpy(data, downmix)


def read_wav(path, downmix: str = "first", native: bool | None = None):
    with open(path, "rb") as f:
        return decode_wav_bytes(f.read(), downmix=downmix, native=native)


def parse_wav_header(data: bytes, file_size: int | None = None) -> tuple[int, int]:
    """bytes → (sample_rate, num_frames) without decoding samples — the
    cheap first phase of the decode-into-buffer feed path.

    data may be a PREFIX of the file when file_size gives the true on-disk
    size: chunk sizes/num_frames are computed against file_size, so a few-KB
    header read suffices. Raises WavError("missing ...") when the needed
    chunk headers lie beyond the prefix — the caller re-reads fully.
    """
    fsize = len(data) if file_size is None else file_size
    lib = _native()
    if lib is not None:
        info = _WavInfo()
        rc = lib.wav_parse_prefix(data, len(data), fsize, ctypes.byref(info))
        if rc != 0:
            raise WavError(_DECODE_ERRORS.get(rc, f"decode error {rc}"))
        return int(info.sample_rate), int(info.num_frames)
    return _parse_numpy_header(data, fsize)


def parse_file_header(path) -> tuple[int, int]:
    """path → (sample_rate, num_frames) in ONE native call (open + 4 KB
    pread + prefix parse, no Python bytes object) — the feed's phase A at
    ctypes-call cost. Falls back to a Python open + full-prefix chain when
    the native lib is unavailable or the chunk headers lie beyond 4 KB."""
    lib = _native()
    if lib is not None:
        info = _WavInfo()
        rc = lib.wav_parse_file(str(path).encode(), ctypes.byref(info))
        if rc == 0:
            return int(info.sample_rate), int(info.num_frames)
        if rc not in (-3, -5):  # NO_FMT / NO_DATA: prefix too small only
            raise WavError(_DECODE_ERRORS.get(rc, f"decode error {rc}"))
    # prefix-first like the consumer-thread parse it replaces: a full
    # f.read() here would pull entire (possibly huge) files through
    # memory just for (sr, n) whenever the native lib is absent
    with open(path, "rb") as f:
        prefix = f.read(8192)
        size = os.fstat(f.fileno()).st_size
        if len(prefix) == 8192:
            try:
                return parse_wav_header(prefix, file_size=size)
            except ValueError:
                return parse_wav_header(prefix + f.read())
        return parse_wav_header(prefix)


def _parse_numpy_header(data: bytes, file_size: int) -> tuple[int, int]:
    """Prefix-aware header parse, numpy-twin semantics of wav_parse_prefix."""
    try:
        if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            raise WavError(
                "not a RIFF/WAVE file" if len(data) >= 12 else "truncated file"
            )
        pos, fmt = 12, None
        d_size = None
        while pos + 8 <= len(data):
            cid = data[pos : pos + 4]
            (csize,) = struct.unpack_from("<I", data, pos + 4)
            body = pos + 8
            if cid == b"fmt ":
                if body + 16 > len(data):
                    raise WavError("truncated file")
                tag, ch, rate, _, _, bits = struct.unpack_from("<HHIIHH", data, body)
                if tag == 0xFFFE:
                    (cb,) = struct.unpack_from("<H", data, body + 16)
                    if cb < 22:
                        raise WavError("unsupported format tag")
                    (tag,) = struct.unpack_from("<H", data, body + 24)
                if tag not in (1, 3) or ch == 0:
                    raise WavError("unsupported format tag")
                fmt = (tag, ch, rate, bits)
            elif cid == b"data":
                d_size = max(0, min(csize, file_size - body))
            pos = body + csize + (csize & 1)
        if fmt is None:
            raise WavError("missing fmt chunk")
        if d_size is None:
            raise WavError("missing data chunk")
        tag, ch, rate, bits = fmt
        if tag == 1 and bits not in (8, 16, 24, 32):
            raise WavError("unsupported bits per sample")
        if tag == 3 and bits not in (32, 64):
            raise WavError("unsupported bits per sample")
        return int(rate), int(d_size // (bits // 8 * ch))
    except struct.error as e:
        raise WavError(f"truncated file ({e})") from e


def _check_row(out_row: np.ndarray, downmix: str) -> bool:
    """Validate a decode target row; returns want_i16."""
    if not out_row.flags.c_contiguous:
        raise ValueError("out_row must be contiguous")
    if out_row.dtype == np.float32:
        want_i16 = False
    elif out_row.dtype == np.int16:
        want_i16 = True
    else:
        raise ValueError("out_row must be float32 or int16")
    if downmix not in ("first", "mean"):
        raise ValueError(f"downmix={downmix!r}")
    return want_i16


def _numpy_into(x: np.ndarray, out_row: np.ndarray, want_i16: bool) -> int:
    n = min(x.shape[0], out_row.shape[0])
    if want_i16:
        # round-half-even + clip — identical to the C path's lrintf
        out_row[:n] = np.clip(np.rint(x[:n]), -32768, 32767).astype(np.int16)
    else:
        out_row[:n] = x[:n]
    out_row[n:] = 0
    return n


def decode_wav_into(
    data: bytes, out_row: np.ndarray, downmix: str = "first",
    native: bool | None = None,
) -> tuple[int, int]:
    """Decode straight into a batch row, truncating to its capacity and
    zero-filling the tail (all inside C for the native path — no
    intermediate array, no GIL during conversion).

    out_row dtype picks the path: float32, or int16 (the half-bandwidth
    feed: PCM16 sources pass through exactly; other widths quantize at
    ±0.5 LSB of the int16 scale — 16-bit-recording precision).
    Returns (sample_rate, n_valid) with n_valid = min(file frames, cap).
    """
    want_i16 = _check_row(out_row, downmix)
    lib = _native() if native is not False else None
    if lib is None:
        if native is True:
            raise RuntimeError("native wav decoder unavailable")
        sr, x = _decode_numpy(data, downmix)
        return sr, _numpy_into(x, out_row, want_i16)
    info = _WavInfo()
    dm = 1 if downmix == "mean" else 0
    if want_i16:
        rc = lib.wav_decode_i16(
            data, len(data), dm,
            out_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out_row.shape[0], ctypes.byref(info),
        )
    else:
        rc = lib.wav_decode_f32(
            data, len(data), dm,
            out_row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_row.shape[0], ctypes.byref(info),
        )
    if rc != 0:
        raise WavError(_DECODE_ERRORS.get(rc, f"decode error {rc}"))
    return int(info.sample_rate), min(int(info.num_frames), out_row.shape[0])


def decode_file_into(
    path, out_row: np.ndarray, downmix: str = "first",
    native: bool | None = None,
) -> tuple[int, int]:
    """One-call file decode into a batch row: open + mmap + decode inside C
    (no Python bytes object, no heap staging buffer) — the per-file cost of
    the feed pipeline's decode phase is a single ctypes call with the GIL
    released. Falls back to read + decode_wav_into without the native lib.
    """
    want_i16 = _check_row(out_row, downmix)
    lib = _native() if native is not False else None
    if lib is None:
        if native is True:
            raise RuntimeError("native wav decoder unavailable")
        with open(path, "rb") as f:
            return decode_wav_into(f.read(), out_row, downmix, native)
    info = _WavInfo()
    rc = lib.wav_decode_file(
        str(path).encode(), 1 if downmix == "mean" else 0, 1 if want_i16 else 0,
        out_row.ctypes.data_as(ctypes.c_void_p),
        out_row.shape[0], ctypes.byref(info),
    )
    if rc != 0:
        raise WavError(_DECODE_ERRORS.get(rc, f"decode error {rc}"))
    return int(info.sample_rate), min(int(info.num_frames), out_row.shape[0])


def write_wav(path, sample_rate: int, samples: np.ndarray) -> None:
    """Minimal PCM16 writer (tests/fixtures only). Values clipped to int16."""
    x = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
    data = x.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)
