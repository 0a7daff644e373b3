"""Shard output writing + resume manifests: the port of
`mfcc_tpu/io/writer.py`. The bytes of every format and the markers are the
JAX package's, so a resume works across the two packages.

Each processed shard writes one `<name>.npz` holding the trimmed features of
its utterances (ragged storage: one concatenated [ΣF_i, D] array + offsets +
ids) and a `done/<name>.json` marker recording the config hash and an input
fingerprint. A restarted run skips shards whose marker matches — extraction
is idempotent and resumable per shard.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import time

import numpy as np

from mfcc_tpu_torch.config import FrontendConfig


def input_fingerprint(ids: list) -> str:
    h = hashlib.sha256()
    for i in ids:
        h.update(str(i).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


class ShardWriter:
    def __init__(self, out_dir, cfg: FrontendConfig, compress: str = "none",
                 fmt: str = "npz"):
        """compress: "none" (default — fp32 features deflate poorly, ~1.1×,
        and zlib caps the writer at ~tens of MB/s/core) or "zlib".
        fmt: "npz" (one ragged shard file per batch, the native layout),
        "htk" (one big-endian HTK parameter file per utterance — toolchain
        interop, `io/htk.py`), or "kaldi" (one binary .ark + .scp pair per
        shard — `io/kaldi.py`); markers/resume work identically for all."""
        if compress not in ("none", "zlib"):
            raise ValueError(f"compress={compress!r} not in ('none', 'zlib')")
        if fmt not in ("npz", "htk", "kaldi"):
            raise ValueError(f"fmt={fmt!r} not in ('npz', 'htk', 'kaldi')")
        self.out_dir = pathlib.Path(out_dir)
        self.done_dir = self.out_dir / "done"
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.done_dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.compress = compress
        self.fmt = fmt

    def _marker(self, shard_name: str) -> pathlib.Path:
        return self.done_dir / f"{shard_name}.json"

    def is_done(self, shard_name: str, ids: list) -> bool:
        """True iff the shard was fully written for the same inputs+config."""
        marker = self._marker(shard_name)
        if not marker.exists():
            return False
        try:
            meta = json.loads(marker.read_text())
        except (OSError, json.JSONDecodeError):
            return False
        if (
            meta.get("config_hash") != self.cfg.config_hash()
            or meta.get("input_fingerprint") != input_fingerprint(ids)
            or meta.get("format", "npz") != self.fmt
        ):
            return False
        if self.fmt in ("htk", "kaldi"):
            return all((self.out_dir / f).exists() for f in meta.get("files", []))
        return (self.out_dir / f"{shard_name}.npz").exists()

    def marker_meta(self, shard_name: str) -> dict | None:
        """Parsed done-marker of a shard, or None."""
        try:
            return json.loads(self._marker(shard_name).read_text())
        except (OSError, json.JSONDecodeError):
            return None

    def write(
        self, shard_name: str, ids: list, features: list[np.ndarray],
        extra_meta: dict | None = None,
    ) -> pathlib.Path:
        """features: per-utterance [F_i, D] arrays (already mask-trimmed).
        extra_meta is stored in the done marker (e.g. the shard's global-CMVN
        moment contribution, so resumed runs recover skipped shards' moments
        from markers instead of silently dropping them)."""
        if len(ids) != len(features):
            raise ValueError("ids/features length mismatch")
        lengths = np.array([f.shape[0] for f in features], dtype=np.int64)
        meta = {
            "config_hash": self.cfg.config_hash(),
            "input_fingerprint": input_fingerprint(ids),
            "format": self.fmt,
            "num_utterances": len(ids),
            "num_frames": int(lengths.sum()),
            "written_at": time.time(),
        }
        if self.fmt == "htk":
            path = self.out_dir
            meta["files"] = self._write_htk_files(ids, features)
        elif self.fmt == "kaldi":
            path = self.out_dir
            meta["files"] = self._write_kaldi_shard(shard_name, ids, features)
        else:
            offsets = np.concatenate([[0], np.cumsum(lengths)])
            flat = (
                np.concatenate(features, axis=0)
                if features
                else np.zeros((0, self.cfg.feat_dim), dtype=np.float32)
            )
            path = self.out_dir / f"{shard_name}.npz"
            # np.savez appends ".npz" unless the name already ends with it
            tmp = self.out_dir / f"{shard_name}.tmp.npz"
            save = np.savez_compressed if self.compress == "zlib" else np.savez
            save(
                tmp,
                features=flat.astype(np.float32),
                offsets=offsets,
                ids=np.array([str(i) for i in ids]),
            )
            tmp.rename(path)  # atomic: readers never see partial shards
        if extra_meta:
            meta["extra"] = extra_meta
        self._marker(shard_name).write_text(json.dumps(meta))
        return path

    def _write_htk_files(self, ids: list, features: list[np.ndarray]) -> list[str]:
        """One <stem>-<idhash>.htk per utterance; the hash suffix keeps
        same-named wavs from different directories from colliding."""
        from mfcc_tpu_torch.io.htk import write_htk

        names = []
        for i, feat in zip(ids, features):
            sid = str(i)
            stem = pathlib.Path(sid).stem or "utt"
            suffix = hashlib.sha256(sid.encode()).hexdigest()[:8]
            name = f"{stem}-{suffix}.htk"
            tmp = self.out_dir / f"{name}.tmp"
            write_htk(tmp, feat, self.cfg)
            tmp.rename(self.out_dir / name)
            names.append(name)
        return names

    def _write_kaldi_shard(self, shard_name: str, ids: list,
                           features: list[np.ndarray]) -> list[str]:
        """One binary <shard>.ark + <shard>.scp per shard (Kaldi archives
        are multi-utterance by design; the scp carries absolute offsets)."""
        from mfcc_tpu_torch.io.kaldi import ArkWriter

        with ArkWriter(self.out_dir / shard_name) as w:
            for i, feat in zip(ids, features):
                w.add(i, feat)
        return [f"{shard_name}.ark", f"{shard_name}.scp"]


def iter_feature_shards(shard_dir) -> list[pathlib.Path]:
    """The feature-shard npz files in a directory, sorted — skipping tmp
    leftovers, moment checkpoints, and any other non-feature npz (e.g. a
    cmvn stats file written into the same directory, the README flow):
    membership is probed from the zip directory only, no array bytes."""
    out = []
    for p in sorted(pathlib.Path(shard_dir).glob("*.npz")):
        if p.name.endswith(".tmp.npz"):
            continue
        try:
            with np.load(p, allow_pickle=False) as z:
                if "features" in z.files:
                    out.append(p)
        except (OSError, ValueError):  # unreadable/corrupt: not a shard
            continue
    return out


def npz_member_shape(path, member: str) -> tuple:
    """Shape of one npz member from its npy header — no data bytes read
    (np.load's member access would decompress the full array)."""
    import zipfile

    from numpy.lib import format as npfmt

    with zipfile.ZipFile(path) as zf:
        with zf.open(member + ".npy") as f:
            version = npfmt.read_magic(f)
            if version == (1, 0):
                shape, _, _ = npfmt.read_array_header_1_0(f)
            else:
                shape, _, _ = npfmt.read_array_header_2_0(f)
            return shape


def read_shard(path) -> dict:
    """Load a shard back into {id: [F, D]} (consumer-side convenience)."""
    with np.load(path, allow_pickle=False) as z:
        feats, offsets, ids = z["features"], z["offsets"], z["ids"]
    return {
        str(ids[i]): feats[offsets[i] : offsets[i + 1]] for i in range(len(ids))
    }


def _host(x) -> np.ndarray:
    """A host array of a numpy array or a torch tensor (on any device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trim_batch(features, frame_mask) -> list[np.ndarray]:
    """[B, F, D] + [B, F] (numpy arrays or torch tensors) → list of [F_i, D]
    valid-frame arrays."""
    features = _host(features)
    n_valid = _host(frame_mask).sum(axis=1).astype(int)
    return [features[i, : n_valid[i]] for i in range(features.shape[0])]
