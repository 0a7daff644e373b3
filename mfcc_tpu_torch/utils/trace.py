"""Tracing: `torch.profiler` around a region, named host spans, and stage
timing for the bench. The port of `mfcc_tpu/utils/trace.py`.

`trace(dir)` wraps a region in a torch.profiler trace of the host and, when
a card is present, the device, and writes it as a Chrome trace into dir.
`annotate(name)` marks host-side spans (decode, dispatch, write) so they
show up beside the device kernels in that trace. `stage_times` times the
chain's stages, by CUDA events on the card and by wall time on the CPU.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

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


def _seconds(fn, on_card: bool) -> float:
    """One run of fn: CUDA events around it on the card (the time the card
    takes for the work fn enqueues), the host clock on the CPU."""
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def stage_times(audio, lengths, cfg, device="cuda", reps: int = 3) -> dict[str, float]:
    """Seconds per chain stage on `device`, the best of `reps` runs after one
    warm-up (which builds the kernels on their first use):
    - "preemph": pre-emphasis and the zeroing past each length (torch ops);
    - "logmel": the front-end on the card (`fused_logmel_stages`, the
      kernel's prefix), the plain chain's `logmel_stages` on the CPU (after
      the plain resample for a resampling config);
    - "full": `chain.extract_batch`;
    - "features_minus_logmel": full - logmel, at least 0.
    On the card each is timed by CUDA events, on the CPU by wall time. A
    bench helper, never on the hot path."""
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to time the plain chain")
    audio = torch.as_tensor(audio, device=device)
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)

    def run_preemph():
        x = audio.to(chain.compute_dtype(cfg))
        return chain.zero_beyond(chain.preemphasis(x, cfg.preemph), lengths)

    def run_logmel():
        if on_card:
            return frontend.fused_logmel_stages(audio, lengths, cfg)
        a, n = chain.resample_input(audio, lengths, cfg) if chain.resamples(cfg) else (audio, lengths)
        return chain.logmel_stages(a, n, cfg)["logmel"]

    def run_full():
        return chain.extract_batch(audio, lengths, cfg, device=device)

    out = {}
    for name, fn in (("preemph", run_preemph), ("logmel", run_logmel), ("full", run_full)):
        fn()
        out[name] = min(_seconds(fn, on_card) for _ in range(reps))
    out["features_minus_logmel"] = max(0.0, out["full"] - out["logmel"])
    return out
