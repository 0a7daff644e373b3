"""Host-side batching of the port (flat int16 or float rows), the
segment/stitch extraction of long utterances, and on-line streaming and
serving."""

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
from mfcc_tpu_torch.pipeline.serving import (  # noqa: F401
    BufferFullError,
    MultiStreamExtractor,
)
from mfcc_tpu_torch.pipeline.streaming import (  # noqa: F401
    StreamingExtractor,
    stream_features,
)
