"""Host I/O of the port: wav decode (C++ fast path + numpy twin), the
threaded and multi-process feeds into flat (pinned, for a CUDA target) batch
rows, shard writers with resume markers, `ShardDataset` over the shards, HTK
and Kaldi output. The JAX package's exports.

The exports load lazily (a module `__getattr__`): `python -m
mfcc_tpu_torch.io.feed_worker` runs this file first, and a feed worker must
load only `wav` and numpy, never the reader's torch.
"""

import importlib

_EXPORTS = {
    "wav": ("WavError", "decode_file_into", "decode_wav_bytes", "decode_wav_into",
            "parse_file_header", "parse_wav_header", "read_wav", "write_wav"),
    "reader": ("DecodeStats", "MpPoolCache", "SlabPool", "decode_stream", "shard_files",
               "stream_batches", "stream_batches_direct", "stream_batches_mp"),
    "dataset": ("ShardDataset",),
    "htk": ("read_htk", "write_htk"),
    "kaldi": ("ArkWriter", "read_ark", "read_scp"),
    "writer": ("ShardWriter", "read_shard", "trim_batch"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value  # later lookups skip this function
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
