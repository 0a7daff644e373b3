"""Host-side batching of the port (flat int16 or float rows) and the
segment/stitch extraction of long utterances."""

from mfcc_tpu_torch.pipeline.batch import (  # noqa: F401
    Batch,
    RowPool,
    bucket_for,
    make_buckets,
    pad_batch,
    required_samples,
)
from mfcc_tpu_torch.pipeline.longform import (  # noqa: F401
    Segment,
    extract_long,
    long_moments,
    segment_plan,
)
