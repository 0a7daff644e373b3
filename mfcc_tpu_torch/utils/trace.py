"""Tracing: `torch.profiler` around a region and named host spans. The port
of `mfcc_tpu/utils/trace.py` :21-37 (its `stage_times` waits for the port's
bench).

`trace(dir)` wraps a region in a torch.profiler trace of the host and, when
a card is present, the device, and writes it as a Chrome trace into dir.
`annotate(name)` marks host-side spans (decode, dispatch, write) so they
show up beside the device kernels in that trace.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler context writing `trace.json` into log_dir; no-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named host-span annotation visible in profiler traces."""
    return torch.profiler.record_function(name)
