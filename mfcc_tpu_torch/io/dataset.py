"""Training-side consumption of feature shards: an iterable dataset over a
directory of extracted npz shards (the `io/writer.py` layout). The port of
`mfcc_tpu/io/dataset.py`, over the port's writer.

Deterministic shuffling (shard order and the row order within a shard),
worker / rank splitting for distributed loaders, utterance and frame counts
without reading feature bytes (the done markers carry them), and a torch
`IterableDataset` wrapper:

    ds = ShardDataset("features/", shuffle=True, seed=0)
    for utt_id, feat in ds:          # feat: [F, D] float32 numpy
        ...
    loader = torch.utils.data.DataLoader(
        ds.as_torch_iterable(), batch_size=None)   # per-utterance
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from mfcc_tpu_torch.io.writer import iter_feature_shards, npz_member_shape

__all__ = ["ShardDataset"]


def _count(shard_dir: pathlib.Path, paths) -> tuple[int, int]:
    """(utterances, frames) totals from the done markers, falling back to
    the npy headers inside the npz when a marker is missing or foreign: no
    feature bytes are read either way."""
    utts = frames = 0
    for p in paths:
        marker = shard_dir / "done" / f"{p.stem}.json"
        try:
            meta = json.loads(marker.read_text())
            utts += int(meta["num_utterances"])
            frames += int(meta["num_frames"])
        except (OSError, KeyError, ValueError):  # json.JSONDecodeError is a ValueError
            utts += npz_member_shape(p, "ids")[0]
            frames += npz_member_shape(p, "features")[0]
    return utts, frames


class ShardDataset:
    """Iterable of ``(utt_id, features)`` over every npz feature shard in a
    directory (moment checkpoints, tmp files and other npz are skipped).

    shuffle: reshuffle the shard order and the row order within each shard
    every epoch (one full ``__iter__``), deterministically from ``seed`` and
    the epoch counter. min_frames drops utterances shorter than the bound
    (e.g. sub-hop clips that gave 1 frame).
    """

    def __init__(self, shard_dir, *, shuffle: bool = False, seed: int = 0,
                 min_frames: int = 0):
        self.shard_dir = pathlib.Path(shard_dir)
        self.shuffle = shuffle
        self.seed = seed
        self.min_frames = int(min_frames)
        self._epoch = 0
        self._paths = iter_feature_shards(self.shard_dir)
        if not self._paths:
            raise FileNotFoundError(f"no feature shards in {self.shard_dir}")
        self._num_utterances, self._num_frames = _count(self.shard_dir, self._paths)

    def __len__(self) -> int:
        """Total utterances across all shards (before min_frames filtering)."""
        return self._num_utterances

    @property
    def num_frames(self) -> int:
        return self._num_frames

    @property
    def num_shards(self) -> int:
        return len(self._paths)

    def split(self, index: int, count: int) -> "ShardDataset":
        """Shard-level split for DataLoader workers / data-parallel ranks:
        worker ``index`` of ``count`` gets every count-th shard, with its
        counts recomputed for the subset."""
        if not 0 <= index < count:
            raise ValueError(f"index {index} not in [0, {count})")
        sub = ShardDataset.__new__(ShardDataset)
        sub.shard_dir = self.shard_dir
        sub.shuffle = self.shuffle
        sub.seed = self.seed + 7919 * index  # decorrelate the workers' row orders
        sub.min_frames = self.min_frames
        sub._epoch = 0
        sub._paths = self._paths[index::count]
        sub._num_utterances, sub._num_frames = _count(self.shard_dir, sub._paths)
        return sub

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self._epoch)) if self.shuffle else None
        self._epoch += 1
        paths = list(self._paths)
        if rng is not None:
            rng.shuffle(paths)
        for p in paths:
            with np.load(p, allow_pickle=False) as z:
                feats, offsets, ids = z["features"], z["offsets"], z["ids"]
            order = np.arange(len(ids))
            if rng is not None:
                rng.shuffle(order)
            for i in order:
                f = feats[offsets[i] : offsets[i + 1]]
                if f.shape[0] < self.min_frames:
                    continue
                yield str(ids[i]), f

    def as_torch_iterable(self):
        """This dataset as a torch IterableDataset whose DataLoader workers
        split the shards among themselves."""
        import torch.utils.data as tud

        ds = self

        class _TorchShardDataset(tud.IterableDataset):
            def __iter__(self):
                info = tud.get_worker_info()
                if info is None:  # num_workers=0: in-process, the epoch counter works
                    yield from ds
                    return
                # a worker iterates a pickled copy, whose epoch never
                # advances; torch reseeds its workers every epoch (info.seed
                # = base_seed + id, base_seed fresh each epoch), so folding
                # it in keeps the reshuffle per epoch
                src = ds.split(info.id, max(info.num_workers, 1))
                src._epoch = info.seed
                yield from src

            def __len__(self):
                return len(ds)

        return _TorchShardDataset()
