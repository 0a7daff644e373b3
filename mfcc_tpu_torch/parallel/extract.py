"""Sharded batch extraction over a `DataMesh`: the port of
`mfcc_tpu/parallel/extract.py` :33-107.

The chain has no coupling between utterances except the global-CMVN
moments, so a batch splits over the mesh's devices and `chain.extract_batch`
runs on each part (on a card: the front-end kernel, and the feature tail for
mfcc configs). The only collective is the all-reduce of the moment triple
(Σx, Σx², n) over the process group when the mesh spans it (the `psum` of
the JAX package's :45-47). A local mesh has no per-batch collective.
`sharded_extract_steps` (a bench helper) waits for the port's bench.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.parallel import cmvn as cmvn_mod
from mfcc_tpu_torch.parallel.mesh import DATA_AXIS, DataMesh, data_mesh, process_count, process_index


def _rows(a, sl: slice) -> torch.Tensor:
    """Rows `sl` of a host array or a tensor, as a tensor (host memory is
    shared, not copied)."""
    if isinstance(a, torch.Tensor):
        return a[sl]
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[sl]))


def put_shards(audio, lengths, mesh: DataMesh, copy_events: list | None = None):
    """This process's rows of the batch, split over the mesh's devices: a
    list of (audio, int32 lengths) on each device. Host rows are copied with
    non_blocking=True (asynchronous from pinned memory); on a card a CUDA
    event is recorded right after each device's copies and appended to
    copy_events, so the caller knows when the host rows may be refilled."""
    B = audio.shape[0]
    d = mesh.shape[DATA_AXIS]
    if B % d != 0:
        raise ValueError(
            f"batch {B} not divisible by data axis {d}; pad with "
            "pipeline.pad_batch(pad_batch_to=...)"
        )
    lo, hi = 0, B
    if mesh.spans_group:
        per = B // process_count()
        lo = process_index() * per
        hi = lo + per
    per_dev = (hi - lo) // len(mesh.devices)
    shards = []
    for i, dev in enumerate(mesh.devices):
        sl = slice(lo + i * per_dev, lo + (i + 1) * per_dev)
        a = _rows(audio, sl).to(dev, non_blocking=True)
        n = _rows(lengths, sl).to(dev, non_blocking=True).to(torch.int32)
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            if copy_events is not None:
                copy_events.append(ev)
        shards.append((a, n))
    return shards


def _gather(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts])


def sharded_extract_batch(
    audio,
    lengths,
    cfg: FrontendConfig,
    mesh: DataMesh | None = None,
    device: str | torch.device = "cuda",
    with_moments: bool | str = False,
    copy_events: list | None = None,
):
    """Extract features with the batch split over the mesh's devices.

    audio: [B, T] host rows (numpy, pinned for a card) or tensors, with B
    divisible by the mesh's data axis; lengths: [B]. mesh None: the local
    mesh of `device`. Returns (features, frame_mask, moments-or-None) on the
    mesh's first device, for this process's rows (all B rows on a local
    mesh); with_moments=True gives the (Σx[D], Σx²[D], n) triple, summed
    over the devices and, when the mesh spans the process group, all-reduced
    over it (one collective); "per_utterance" the per-row (Σx[B, D],
    Σx²[B, D], n[B]) triples (speaker CMVN, no collective). copy_events: see
    `put_shards`."""
    if mesh is None:
        mesh = data_mesh(local=True, device=device)
    shards = put_shards(audio, lengths, mesh, copy_events)
    feats, masks, moms = [], [], []
    for dev, (a, n) in zip(mesh.devices, shards):
        feat, mask = chain.extract_batch(a, n, cfg, device=dev)
        feats.append(feat)
        masks.append(mask)
        if with_moments == "per_utterance":
            moms.append(cmvn_mod.utterance_moments(feat, mask))
        elif with_moments:
            moms.append(cmvn_mod.batch_moments(feat, mask))
    home = mesh.devices[0]
    feat, mask = _gather(feats, home), _gather(masks, home)
    if not with_moments:
        return feat, mask, None
    if with_moments == "per_utterance":
        return feat, mask, tuple(_gather([m[k] for m in moms], home) for k in range(3))
    D = feat.shape[-1]
    # one vector [Σx | Σx² | n] a device, summed on the first, then one
    # all-reduce over the group
    total = sum(torch.cat([s1, s2, n.to(s1.dtype)[None]]).to(home) for s1, s2, n in moms)
    if mesh.spans_group:
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return feat, mask, (total[:D], total[D:2 * D], total[2 * D])
