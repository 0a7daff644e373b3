"""The port's `ShardDataset` (`mfcc_tpu_torch.io.dataset`) ≡ the JAX
package's (`mfcc_tpu.io.dataset`), on shards written by either package's
`ShardWriter`: the reference's tests/test_dataset.py cases (counts from the
markers and, without them, from the npz headers; deterministic shuffling
that changes by epoch; splits that partition the set; min_frames; foreign
npz skipped; the torch bridge, in-process and with worker processes), and
the same utterances in the same order as the reference's dataset for the
same seed, epoch and split.
"""

import shutil

import numpy as np
import pytest

from mfcc_tpu.config import named_config as jnamed_config
from mfcc_tpu.io import ShardDataset as JShardDataset
from mfcc_tpu.io.writer import ShardWriter as JShardWriter
from mfcc_tpu_torch.config import named_config
from mfcc_tpu_torch.io import ShardDataset, ShardWriter

WRITERS = ("port", "jax")


@pytest.fixture(params=WRITERS)
def shards(tmp_path, request):
    """Four shards of five utterances of 3-31 frames, written by the port's
    or the JAX package's writer."""
    g = np.random.default_rng(41)
    if request.param == "port":
        w = ShardWriter(tmp_path, named_config("classic13"))
    else:
        w = JShardWriter(tmp_path, jnamed_config("classic13"))
    truth = {}
    for s in range(4):
        ids, feats = [], []
        for u in range(5):
            uid = f"/c/s{s}/u{u}.wav"
            f = g.standard_normal((3 + 7 * u, 13)).astype(np.float32)
            ids.append(uid)
            feats.append(f)
            truth[uid] = f
        w.write(f"h0-{s:06d}", ids, feats)
    return tmp_path, truth


def _same(got: list, want: list) -> bool:
    return [k for k, _ in got] == [k for k, _ in want] and all(
        np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))


def test_iteration_complete_and_exact(shards):
    root, truth = shards
    ds = ShardDataset(root)
    got = list(ds)
    assert dict(got).keys() == truth.keys()
    for k, v in got:
        np.testing.assert_array_equal(v, truth[k])
        assert v.dtype == np.float32
    assert len(ds) == 20
    assert ds.num_frames == sum(f.shape[0] for f in truth.values())
    assert ds.num_shards == 4
    assert _same(got, list(JShardDataset(root)))


def test_counts_without_markers(shards):
    """Marker-less shards (foreign corpora) are counted from the npz
    headers."""
    root, truth = shards
    shutil.rmtree(root / "done")
    ds = ShardDataset(root)
    assert len(ds) == 20
    assert ds.num_frames == sum(f.shape[0] for f in truth.values())


def test_shuffle_deterministic_and_epoch_varying(shards):
    root, truth = shards
    a = list(ShardDataset(root, shuffle=True, seed=3))
    ds, jds = ShardDataset(root, shuffle=True, seed=3), JShardDataset(root, shuffle=True, seed=3)
    b1, b2 = list(ds), list(ds)  # epochs 1 and 2
    assert [k for k, _ in a] == [k for k, _ in b1]  # the same seed and epoch
    assert [k for k, _ in b1] != [k for k, _ in b2]  # reshuffled each epoch
    assert {k for k, _ in b2} == set(truth)
    assert [k for k, _ in a] != sorted(truth)  # shuffled
    assert _same(b1, list(jds)) and _same(b2, list(jds))  # the reference's orders


def test_split_partitions(shards):
    root, truth = shards
    ds, jds = ShardDataset(root, shuffle=True, seed=1), JShardDataset(root, shuffle=True, seed=1)
    parts = [ds.split(i, 3) for i in range(3)]
    keys = [k for p in parts for k, _ in p]
    assert sorted(keys) == sorted(truth)  # disjoint and complete
    assert sum(len(p) for p in parts) == len(ds)
    assert sum(p.num_frames for p in parts) == ds.num_frames
    assert all(_same(list(ds.split(i, 3)), list(jds.split(i, 3))) for i in range(3))
    with pytest.raises(ValueError):
        ds.split(3, 3)


def test_min_frames_filter(shards):
    root, truth = shards
    got = list(ShardDataset(root, min_frames=10))
    assert dict(got).keys() == {k for k, f in truth.items() if f.shape[0] >= 10}
    assert _same(got, list(JShardDataset(root, min_frames=10)))


def test_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ShardDataset(tmp_path)


def test_torch_bridge(shards):
    root, truth = shards
    import torch.utils.data as tud

    ds = ShardDataset(root).as_torch_iterable()
    assert len(ds) == 20
    loader = tud.DataLoader(ds, batch_size=None, num_workers=0)
    got = {k: np.asarray(v) for k, v in loader}
    assert set(got) == set(truth)
    for k in truth:
        np.testing.assert_array_equal(got[k], truth[k])


def test_foreign_npz_in_dir_is_skipped(shards):
    """A CMVN stats npz written into the output directory (the README's
    flow) and a file that is no zip are not shards."""
    root, truth = shards
    np.savez(root / "cmvn.npz", s1=np.zeros(13), s2=np.zeros(13), n=np.float64(1))
    (root / "garbage.npz").write_bytes(b"not a zip at all")
    ds = ShardDataset(root)
    assert ds.num_shards == 4 and len(ds) == 20
    assert set(dict(ds)) == set(truth)


def test_torch_workers_reshuffle_each_epoch(shards):
    """With worker processes each epoch still sees a fresh order (workers
    iterate pickled copies; torch's per-epoch worker seed is folded into
    the rng)."""
    root, truth = shards
    import torch
    import torch.utils.data as tud

    ds = ShardDataset(root, shuffle=True, seed=5).as_torch_iterable()
    g = torch.Generator()
    g.manual_seed(11)
    loader = tud.DataLoader(ds, batch_size=None, num_workers=2, generator=g)
    e1 = [k for k, _ in loader]
    e2 = [k for k, _ in loader]
    assert set(e1) == set(e2) == set(truth)  # complete in both epochs
    assert e1 != e2  # reshuffled across epochs
