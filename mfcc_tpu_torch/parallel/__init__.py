"""Data-parallel execution over cards and processes (`torch.distributed`):
the port of `mfcc_tpu/parallel/`. Batches split on their leading axis over
the mesh's devices, files over processes, and the one collective is the
all-reduce of the global-CMVN moment triple (Σx, Σx², n)."""

from mfcc_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    data_mesh,
    distributed_init,
    pad_batch_to_shards,
    process_count,
    process_index,
)
from mfcc_tpu_torch.parallel.extract import sharded_extract_batch  # noqa: F401
from mfcc_tpu_torch.parallel.cmvn import (  # noqa: F401
    CmvnAccumulator,
    CmvnStats,
    SpeakerCmvnAccumulator,
    apply_cmvn,
    batch_moments,
    is_speaker_stats,
    read_utt2spk,
    speaker_of,
    utterance_moments,
)
