"""The port's data-parallel layer ≡ the JAX package's (`mfcc_tpu.parallel`).

- the moment triples of `batch_moments` / `utterance_moments` equal the JAX
  package's on the same float32 features;
- `sharded_extract_batch` on a local CPU mesh gives `chain.extract_batch`'s
  features and their moments;
- a 2-process gloo run (`torch.distributed`, a mesh that spans the group)
  gives each rank its rows of the 1-rank features (within the feature
  gates: two rows a process against four), and the all-reduced
  moments equal the 1-rank moments (float32 sums in another order: rtol
  1e-5), for global and per-utterance moments;
- the mesh helpers, and no process group without torchrun's variables.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_tpu.parallel import cmvn as jcmvn
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.parallel import cmvn as tcmvn
from mfcc_tpu_torch.parallel import mesh as tmesh
from mfcc_tpu_torch.parallel import sharded_extract_batch
from mfcc_tpu_torch.pipeline import pad_batch
from mfcc_tpu_torch.testing import assert_family_features_close, assert_features_close

REPO = pathlib.Path(__file__).resolve().parents[1]
MOMENT_RTOL = 1e-5  # float32 sums of ~1e3 terms in another order


def _batch(cfg, rows: int = 4, seed: int = 3):
    g = np.random.default_rng(seed)
    utts = [(g.standard_normal(3000 + 1700 * i) * 3000).astype(np.int16) for i in range(rows)]
    return pad_batch(utts, cfg, dtype="int16")


def test_moments_match_reference():
    g = np.random.default_rng(1)
    feat = g.standard_normal((3, 7, 5)).astype(np.float32) * 4
    mask = (np.arange(7)[None, :] < np.array([7, 3, 0])[:, None]).astype(np.float32)
    for tfn, jfn in ((tcmvn.batch_moments, jcmvn.batch_moments),
                     (tcmvn.utterance_moments, jcmvn.utterance_moments)):
        got = tfn(torch.as_tensor(feat), torch.as_tensor(mask))
        want = jfn(jnp.asarray(feat), jnp.asarray(mask))
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("with_moments", [False, True, "per_utterance"])
def test_sharded_extract_on_a_local_cpu_mesh(with_moments):
    cfg = T_CONFIGS["classic13_deltas_gcmvn"]
    b = _batch(cfg)
    mesh = tmesh.data_mesh(local=True, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.shape == {"data": 1}
    events = []
    feat, mask, mom = sharded_extract_batch(b.audio, b.lengths, cfg, mesh,
                                            with_moments=with_moments, copy_events=events)
    assert events == []  # CPU rows are not copied
    want, want_mask = chain.extract_batch(b.audio, b.lengths, cfg, device="cpu")
    assert torch.equal(feat, want) and torch.equal(mask, want_mask)
    if not with_moments:
        assert mom is None
        return
    fn = tcmvn.utterance_moments if with_moments == "per_utterance" else tcmvn.batch_moments
    for a, w in zip(mom, fn(want, want_mask)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-6)


def test_mesh_helpers_and_no_group_without_torchrun(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    tmesh.distributed_init()
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    mesh = tmesh.data_mesh(device="cpu")
    assert not mesh.spans_group
    assert tmesh.pad_batch_to_shards(5, mesh) == 5
    assert tmesh.pad_batch_to_shards(5, tmesh.DataMesh((torch.device("cpu"),) * 4)) == 8
    cfg = T_CONFIGS["classic13"]
    b = _batch(cfg, rows=3)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_extract_batch(b.audio, b.lengths, cfg,
                              tmesh.DataMesh((torch.device("cpu"),) * 2))
    with pytest.raises(ValueError, match="neither"):
        tmesh.data_mesh(device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.data_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_extract_batch(b.audio, b.lengths, cfg)


_WORKER = """
import sys
import numpy as np
import torch
from mfcc_tpu_torch.config import NAMED_CONFIGS
from mfcc_tpu_torch.parallel import data_mesh, distributed_init, process_count, process_index
from mfcc_tpu_torch.parallel import sharded_extract_batch
from mfcc_tpu_torch.pipeline import pad_batch

init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
distributed_init(init_method=init, world_size=2, rank=rank)
assert (process_index(), process_count()) == (rank, 2)
res = {}
for name, moments in (("classic13_deltas_gcmvn", True), ("kaldi_plp", "per_utterance")):
    cfg = NAMED_CONFIGS[name]
    g = np.random.default_rng(3)
    utts = [(g.standard_normal(3000 + 1700 * i) * 3000).astype(np.int16) for i in range(4)]
    b = pad_batch(utts, cfg, dtype="int16")
    mesh = data_mesh(device="cpu")
    assert mesh.spans_group and mesh.shape == {"data": 2}
    feat, mask, mom = sharded_extract_batch(b.audio, b.lengths, cfg, mesh, with_moments=moments)
    res[name + "/feat"], res[name + "/mask"] = feat.numpy(), mask.numpy()
    for k, m in zip(("s1", "s2", "n"), mom):
        res[name + "/" + k] = m.numpy()
np.savez(out, **res)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_run_matches_one_rank(tmp_path):
    init = f"tcp://localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, init, str(r), str(tmp_path / f"r{r}.npz")],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    ranks = [np.load(tmp_path / f"r{r}.npz") for r in range(2)]
    for name, moments in (("classic13_deltas_gcmvn", True), ("kaldi_plp", "per_utterance")):
        cfg = T_CONFIGS[name]
        b = _batch(cfg)
        feat, mask, mom = sharded_extract_batch(b.audio, b.lengths, cfg, device="cpu",
                                                with_moments=moments)
        for r, z in enumerate(ranks):
            rows = slice(2 * r, 2 * r + 2)  # rank r's half of the batch
            # two rows a process against four: the CPU chain's float32
            # sums may round apart, so the features are held to their gates
            if cfg.features == "mfcc":
                assert_features_close(z[name + "/feat"], feat[rows].numpy())
            else:
                assert_family_features_close(z[name + "/feat"], feat[rows].numpy(), cfg.features)
            np.testing.assert_array_equal(z[name + "/mask"], mask[rows].numpy())
            for k, m in zip(("s1", "s2", "n"), mom):
                want = m.numpy() if moments is True else m[rows].numpy()
                np.testing.assert_allclose(z[f"{name}/{k}"], want, rtol=MOMENT_RTOL)
