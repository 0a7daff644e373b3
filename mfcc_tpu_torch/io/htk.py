"""HTK parameter-file output (.htk/.mfc) — the classic interchange format
for MFCC features: the port of `mfcc_tpu/io/htk.py`, the same bytes.

Format (HTK Book §5.10): a 12-byte big-endian header
    nSamples   int32   frames in the file
    sampPeriod int32   frame hop in 100 ns units
    sampSize   int16   bytes per frame (4 * feat_dim)
    parmKind   int16   base kind + qualifier bits
followed by nSamples * sampSize bytes of big-endian float32.

parmKind mapping from FrontendConfig: MFCC (6) / FBANK (7) base, _E when
energy is carried, _D/_A for the delta stack, _Z when CMVN is applied.

Layout: HTK's _E convention puts energy LAST in each static/Δ/ΔΔ block;
the psf-lineage extractor carries ln-energy in column 0 of each block
(c0 replaced). `write_htk` therefore rolls column 0 of every block to the
block's end so the bytes follow the advertised parmKind exactly —
[c1..c12, E, Δc1..Δc12, ΔE, ...] — and HTK-family consumers decode the
columns correctly. `read_htk` returns the file's (HTK) layout.
"""

from __future__ import annotations

import struct

import numpy as np

from mfcc_tpu_torch.config import FrontendConfig

__all__ = ["parm_kind", "write_htk", "read_htk", "energy_last_permutation",
           "KIND_NAMES"]

_BASE_MFCC = 6
_BASE_FBANK = 7
_BASE_USER = 9  # HTK's user-defined kind — used for SSC (no native kind)
_BASE_PLP = 11  # HTK's native PLP kind
_Q_E = 0o000100
_Q_D = 0o000400
_Q_A = 0o001000
_Q_Z = 0o004000

KIND_NAMES = {_BASE_MFCC: "MFCC", _BASE_FBANK: "FBANK", _BASE_USER: "USER",
              _BASE_PLP: "PLP"}


def parm_kind(cfg: FrontendConfig) -> int:
    """HTK parmKind code for this config's output layout."""
    kind = {"mfcc": _BASE_MFCC, "logmel": _BASE_FBANK,
            "ssc": _BASE_USER, "plp": _BASE_PLP,
            # per-FFT-bin log power spectrum has no native HTK kind
            # (FBANK/MELSPEC are mel-bank layouts); USER like SSC. The
            # energy is REPLACED into lane 0 (Kaldi semantics), not
            # appended, so no _E qualifier.
            "spectrogram": _BASE_USER}[cfg.features]
    if cfg.features in ("mfcc", "plp") and cfg.append_energy:
        kind |= _Q_E
    if cfg.deltas >= 1:
        kind |= _Q_D
    if cfg.deltas >= 2:
        kind |= _Q_A
    if cfg.cmvn != "off":
        kind |= _Q_Z
    return kind


def kind_string(kind: int) -> str:
    """Human-readable parmKind, e.g. 'MFCC_E_D_A'."""
    s = KIND_NAMES.get(kind & 0o77, str(kind & 0o77))
    for bit, q in ((_Q_E, "E"), (_Q_D, "D"), (_Q_A, "A"), (_Q_Z, "Z")):
        if kind & bit:
            s += f"_{q}"
    return s


def energy_last_permutation(cfg: FrontendConfig) -> np.ndarray | None:
    """Column permutation mapping the extractor layout (energy first per
    block) to HTK's _E layout (energy last per block), or None if the
    config carries no energy column."""
    if cfg.features not in ("mfcc", "plp") or not cfg.append_energy:
        return None
    d = cfg.n_ceps
    blocks = [
        np.concatenate([np.arange(b * d + 1, (b + 1) * d), [b * d]])
        for b in range(1 + cfg.deltas)
    ]
    return np.concatenate(blocks)


def write_htk(path, feat: np.ndarray, cfg: FrontendConfig) -> None:
    """Write one utterance's [F, D] extractor-layout features as an HTK
    parameter file (energy columns rolled to block ends, see module doc)."""
    feat = np.ascontiguousarray(np.asarray(feat, dtype=np.float32))
    if feat.ndim != 2:
        raise ValueError(f"expected [F, D] features, got shape {feat.shape}")
    perm = energy_last_permutation(cfg)
    if perm is not None and feat.shape[1] == perm.shape[0]:
        feat = feat[:, perm]
    sample_period = round(cfg.frame_step / cfg.sample_rate * 1e7)  # 100 ns
    header = struct.pack(
        ">iihh", feat.shape[0], sample_period, 4 * feat.shape[1], parm_kind(cfg)
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(feat.astype(">f4").tobytes())


def read_htk(path) -> tuple[np.ndarray, dict]:
    """Read an HTK parameter file -> ([F, D] float32, header metadata)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12:
        raise ValueError(f"{path}: truncated HTK header ({len(raw)} bytes)")
    n, period, samp_size, kind = struct.unpack(">iihh", raw[:12])
    if n < 0:
        raise ValueError(f"{path}: bad nSamples {n}")
    if samp_size <= 0 or samp_size % 4:
        raise ValueError(f"{path}: bad sampSize {samp_size} (not float32 rows)")
    dim = samp_size // 4
    body = raw[12:]
    if len(body) < n * samp_size:
        raise ValueError(
            f"{path}: expected {n * samp_size} data bytes, got {len(body)}"
        )
    feat = np.frombuffer(body[: n * samp_size], dtype=">f4").reshape(n, dim)
    meta = {
        "num_frames": n,
        "sample_period_100ns": period,
        "feat_dim": dim,
        "parm_kind": kind,
        "parm_kind_str": kind_string(kind),
    }
    return feat.astype(np.float32), meta
