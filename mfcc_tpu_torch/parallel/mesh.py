"""Data-parallel layout over `torch.distributed`: the port of
`mfcc_tpu/parallel/mesh.py`.

The model is tiny, so the only parallelism is data parallelism over
utterances: batches split on their leading axis over cards, files split over
processes (`io.reader.shard_files`), and one collective on the path, the
all-reduce of the global-CMVN moment triple (`parallel.extract`).

`distributed_init` joins a process group only when torchrun's variables are
set (or an address is passed): NCCL on CUDA, gloo on the CPU. Otherwise it
does nothing, and `process_index` / `process_count` are 0 / 1.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DATA_AXIS = "data"
_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def distributed_init(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group. No-op when one is already joined, and when
    neither `init_method` is given nor torchrun's variables (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) are set: a single process creates no
    group. The backend is NCCL when CUDA is available (each process on the
    card LOCAL_RANK), else gloo."""
    if _grouped():
        return
    explicit = init_method is not None
    auto = all(os.environ.get(k) is not None for k in _TORCHRUN_VARS)
    if not (explicit or auto):
        return
    cuda = torch.cuda.is_available()
    if cuda and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(
        backend or ("nccl" if cuda else "gloo"), init_method=init_method or "env://", **kw
    )
    log.info("torch.distributed initialized: process %d/%d, backend %s",
             dist.get_rank(), dist.get_world_size(), dist.get_backend())


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The cards (or the CPU) this process computes on, and whether the
    mesh spans every process of the group (`spans_group`): then a batch is
    the global batch, each process takes its rows, and moments are
    all-reduced over the group."""

    devices: tuple[torch.device, ...]
    spans_group: bool = False

    @property
    def shape(self) -> dict[str, int]:
        """{"data": shards of a batch}: this process's devices, times the
        processes when the mesh spans the group."""
        procs = process_count() if self.spans_group else 1
        return {DATA_AXIS: len(self.devices) * procs}


def data_mesh(n_devices: int | None = None, local: bool = False,
              device: str | torch.device = "cuda") -> DataMesh:
    """1-D data-parallel mesh.

    device "cuda": this process's cards (the card LOCAL_RANK in a process
    group, as torchrun sets one a process; else every visible card), or the
    first n_devices of them; no card raises. device "cpu": the CPU.

    local=True keeps the mesh to this process. The streaming CLI must use a
    local mesh: per-process file shards give different batch counts per
    process, so a collective inside the per-batch step would deadlock.
    Global-CMVN moments then sum over this process's cards per batch, and
    over processes through the per-process moment files that `apply-cmvn`
    merges. local=False spans every process of the group, for lockstep
    work where every process runs the same steps."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the mesh runs on the card by default; pass "
                "device='cpu' for the plain chain"
            )
        if _grouped():
            devices = [torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                               torch.cuda.current_device())))]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif dev.type == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    if n_devices is not None:
        devices = devices[:n_devices]
    return DataMesh(tuple(devices), spans_group=not local and process_count() > 1)


def pad_batch_to_shards(n: int, mesh: DataMesh) -> int:
    """Smallest batch size >= n divisible by the data-axis size."""
    d = mesh.shape[DATA_AXIS]
    return ((n + d - 1) // d) * d
