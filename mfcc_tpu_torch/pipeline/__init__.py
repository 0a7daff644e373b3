"""Host-side batching of the port (flat int16 or float rows)."""

from mfcc_tpu_torch.pipeline.batch import (  # noqa: F401
    Batch,
    bucket_for,
    make_buckets,
    pad_batch,
    required_samples,
)
