"""Host I/O of the port: wav decode (C++ fast path + numpy twin), the
threaded feed into flat (pinned, for a CUDA target) batch rows, shard
writers with resume markers, HTK and Kaldi output. The JAX package's
exports, minus its multi-process feed and `ShardDataset` (not ported yet)."""

from mfcc_tpu_torch.io.wav import (  # noqa: F401
    WavError,
    decode_file_into,
    decode_wav_bytes,
    decode_wav_into,
    parse_file_header,
    parse_wav_header,
    read_wav,
    write_wav,
)
from mfcc_tpu_torch.io.reader import (  # noqa: F401
    DecodeStats,
    decode_stream,
    shard_files,
    stream_batches,
    stream_batches_direct,
)
from mfcc_tpu_torch.io.htk import read_htk, write_htk  # noqa: F401
from mfcc_tpu_torch.io.kaldi import ArkWriter, read_ark, read_scp  # noqa: F401
from mfcc_tpu_torch.io.writer import ShardWriter, read_shard, trim_batch  # noqa: F401
