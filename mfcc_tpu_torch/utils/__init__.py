"""Shared utilities of the port: structured metrics and tracing."""

from mfcc_tpu_torch.utils.metrics import MetricsLogger, Timer  # noqa: F401
