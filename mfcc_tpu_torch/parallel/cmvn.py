"""Global (corpus-level) and speaker CMVN: moment accumulation +
application. The port of `mfcc_tpu/parallel/cmvn.py`.

Masked moment triples (Σx, Σx², n) are summed on the device in the
features' dtype (float32, as the JAX package sums them); over a process
group `parallel.extract.sharded_extract_batch` all-reduces them, the one
collective of the path. The host-side accumulators fold batches (and
processes' checkpoints) together in float64, with the JAX package's `.npz`
checkpoint format, so either package loads the other's moments file.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from mfcc_tpu_torch.config import FrontendConfig


def batch_moments(feat: torch.Tensor, frame_mask: torch.Tensor):
    """Masked moment triple of one batch, on its device.

    feat: [B, F, D]; frame_mask: [B, F]. Returns (s1[D], s2[D], n[]) summed
    over batch and frames in feat's dtype.
    """
    m = frame_mask[..., None].to(feat.dtype)
    s1 = (feat * m).sum(dim=(0, 1))
    s2 = (feat * feat * m).sum(dim=(0, 1))
    n = frame_mask.sum()
    return s1, s2, n


def utterance_moments(feat: torch.Tensor, frame_mask: torch.Tensor):
    """Per-utterance masked moment triples: (s1[B, D], s2[B, D], n[B]) —
    the speaker-CMVN building block (the host groups rows by speaker, so
    no collective is needed)."""
    m = frame_mask[..., None].to(feat.dtype)
    s1 = (feat * m).sum(dim=1)
    s2 = (feat * feat * m).sum(dim=1)
    n = frame_mask.sum(dim=1)
    return s1, s2, n


@dataclasses.dataclass
class CmvnStats:
    """Finalized corpus statistics."""

    mean: np.ndarray  # [D]
    std: np.ndarray  # [D] (sqrt(var + eps))
    n: float


class CmvnAccumulator:
    """Streaming (Σx, Σx², n) accumulator with checkpoint/resume."""

    def __init__(self, dim: int):
        self.s1 = np.zeros(dim, dtype=np.float64)
        self.s2 = np.zeros(dim, dtype=np.float64)
        self.n = 0.0

    def add(self, s1, s2, n) -> None:
        self.s1 += np.asarray(s1, dtype=np.float64)
        self.s2 += np.asarray(s2, dtype=np.float64)
        self.n += float(n)

    def merge(self, other: "CmvnAccumulator") -> None:
        self.add(other.s1, other.s2, other.n)

    def finalize(self, cfg: FrontendConfig) -> CmvnStats:
        if self.n <= 0:
            raise ValueError("no frames accumulated")
        mean = self.s1 / self.n
        var = self.s2 / self.n - mean * mean
        return CmvnStats(
            mean=mean, std=np.sqrt(np.maximum(var, 0.0) + cfg.cmvn_eps), n=self.n
        )

    # -- checkpointing ------------------------------------------------------

    def save(self, path: str | pathlib.Path) -> None:
        np.savez(path, s1=self.s1, s2=self.s2, n=np.float64(self.n))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "CmvnAccumulator":
        with np.load(path) as z:
            acc = cls(z["s1"].shape[0])
            acc.s1[:] = z["s1"]
            acc.s2[:] = z["s2"]
            acc.n = float(z["n"])
        return acc


def apply_cmvn(feat, frame_mask, mean, std, var_norm: bool = True) -> torch.Tensor:
    """Apply finalized global stats to features [..., F, D] (a tensor or an
    array; the stats are cast to feat's dtype and device); pad frames stay
    exactly zero."""
    feat = torch.as_tensor(feat)
    mean = torch.as_tensor(mean, dtype=feat.dtype, device=feat.device)
    out = feat - mean
    if var_norm:
        out = out / torch.as_tensor(std, dtype=feat.dtype, device=feat.device)
    mask = torch.as_tensor(frame_mask, device=feat.device)
    return out * mask[..., None].to(feat.dtype)


# ---------------------------------------------------------------------------
# Speaker-level CMVN (Kaldi-style): per-speaker moment pools
# ---------------------------------------------------------------------------


def speaker_of(utt_id, utt2spk: dict | None = None, mode: str = "dir") -> str:
    """Speaker id for an utterance id (usually a wav path).

    utt2spk (Kaldi utt2spk semantics) is consulted first — by exact id,
    then basename, then stem; otherwise mode "dir" uses the parent
    directory name (the spk/utt.wav corpus layout). Unknown ids under an
    explicit utt2spk raise KeyError so a bad map cannot silently pool
    everything into path-derived speakers."""
    sid = str(utt_id)
    if utt2spk is not None:
        p = pathlib.PurePath(sid)
        for key in (sid, p.name, p.stem):
            if key in utt2spk:
                return utt2spk[key]
        raise KeyError(f"utterance {sid!r} not in utt2spk")
    if mode == "dir":
        return pathlib.PurePath(sid).parent.name or "unknown"
    raise ValueError(f"unknown speaker mode {mode!r}")


def read_utt2spk(path) -> dict:
    """Kaldi utt2spk file: '<utt> <spk>' per line, comments/blanks skipped."""
    out = {}
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2:
            raise ValueError(f"utt2spk line not '<utt> <spk>': {line!r}")
        out[parts[0]] = parts[1]
    return out


class SpeakerCmvnAccumulator:
    """Per-speaker (Σx, Σx², n) pools with the same checkpoint/merge
    contract as CmvnAccumulator (moment triples are additive, so per-host
    files merge exactly by speaker key)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.pools: dict[str, CmvnAccumulator] = {}

    def add(self, spk: str, s1, s2, n) -> None:
        self.pools.setdefault(spk, CmvnAccumulator(self.dim)).add(s1, s2, n)

    def merge(self, other: "SpeakerCmvnAccumulator") -> None:
        for spk, acc in other.pools.items():
            self.add(spk, acc.s1, acc.s2, acc.n)

    @property
    def n(self) -> float:
        return sum(a.n for a in self.pools.values())

    def finalize(self, cfg: FrontendConfig) -> dict[str, CmvnStats]:
        """Per-speaker stats; pools with zero frames are dropped (a
        speaker whose only utterance produced 0 frames must not block
        normalizing the rest of the corpus — its utterances then resolve
        as unknown-speaker, the loud failure)."""
        return {s: a.finalize(cfg) for s, a in self.pools.items() if a.n > 0}

    def save(self, path) -> None:
        spks = sorted(self.pools)
        np.savez(
            path,
            spks=np.array(spks),
            s1=np.stack([self.pools[s].s1 for s in spks])
            if spks else np.zeros((0, self.dim)),
            s2=np.stack([self.pools[s].s2 for s in spks])
            if spks else np.zeros((0, self.dim)),
            n=np.array([self.pools[s].n for s in spks], dtype=np.float64),
        )

    @classmethod
    def load(cls, path) -> "SpeakerCmvnAccumulator":
        with np.load(path, allow_pickle=False) as z:
            if "spks" not in z.files:
                raise ValueError(
                    f"{path}: not a speaker-CMVN stats file (no 'spks'; "
                    "global stats go to the non-speaker apply path)"
                )
            acc = cls(z["s1"].shape[1] if z["s1"].size else 0)
            for i, spk in enumerate(z["spks"]):
                acc.add(str(spk), z["s1"][i], z["s2"][i], float(z["n"][i]))
        return acc


def is_speaker_stats(path) -> bool:
    """True when the npz at path holds per-speaker pools."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return "spks" in z.files
    except (OSError, ValueError):
        return False
