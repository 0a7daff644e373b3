#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mfcc_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build the main path's kernel from the checkout's source (nvcc) and
     print ptxas usage;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (classic13_deltas, batch 64 x 10 s int16 PCM, lengths
     n - 571*i): the test_kernel_matches_jnp_twin gates, int16 rows ≡ the
     same rows in float32 bitwise, boundary lengths, and garbage past each
     length leaving the output unchanged;
  4. the main path, `mfcc_tpu_torch.ops.chain.extract_batch` on the card,
     with every launch count set to 0 just before and read just after;
     features [64, 999, 39], finite, pad frames exactly 0, within 5e-4 of the
     same call on the CPU and of the float64 plain chain on four rows;
  5. times with CUDA events after warm-up (median of launches with the 50 MB
     L2 flushed before each), each beside the card's name and power limit;
     `bound_ms` is computed from this run's inputs against the H100 SXM
     peaks (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores); a
     torch.profiler pass over five steps gives device kernels per step,
     device busy time and the step's idle share. The operation count is the
     function's minimum, not this kernel's form: a split-radix 256-point
     complex FFT, the real split with its 1/2 scalings folded into the
     power scale, and the mel sums over the filters' nonzero weights.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a card it exits 2 and prints neither.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

CONFIG = "classic13_deltas"
B, SECONDS = 64, 10
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32, outside the tensor cores
BOUNDARY_LENGTHS = [0, 1, 399, 400, 401, 32 * 160 - 1, 32 * 160, 32 * 160 + 1]
KERNEL = {
    "name": "frontend_logmel",
    "route": "cuda",
    "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
    "replaces": "mfcc_tpu/kernels/frontend.py:905",
}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def check_prefix(testing, got, want, n_mels: int, what: str) -> dict[str, float]:
    errs = testing.prefix_errors(got, want, n_mels)
    print(f"  {what}: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    failures = testing.prefix_failures(errs)
    check(not failures, f"{what}: within the kernel-vs-plain gates {failures or ''}")
    return errs


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over reps launches, L2 flushed before each."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import _build, frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    print("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "", "nvidia-smi reads the card")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); device 0: {kind}; "
          f"{torch.cuda.device_count()} device(s)")
    tag = f"[{card}]"

    # 2. build the kernel
    print("== 2. build")
    t0 = time.perf_counter()
    path, log = _build.build("frontend")
    print(f"built {path.name} in {time.perf_counter() - t0:.1f} s: "
          f"nvcc {' '.join(_build.NVCC_FLAGS)}")
    for line in log.splitlines():
        if "ptxas" in line or "spill" in line:
            print(f"    {line.strip()}")

    # the main path's input: int16 noise x3000, lengths n - 571*i
    cfg = named_config(CONFIG)
    n = cfg.sample_rate * SECONDS
    g = np.random.default_rng(0)
    utts = [(g.standard_normal(n - 571 * i) * 3000).astype(np.int16) for i in range(B)]
    batch = pad_batch(utts, cfg, bucket_len=n, dtype="int16")
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")

    # 3. kernel vs plain version on the card
    print(f"== 3. kernel vs plain version, {CONFIG} b{B} x {SECONDS} s int16 [{B}, {T}]")
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg)
    errs = check_prefix(testing, got, plain, M, "main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    t = torch.arange(T, device="cuda")[None, :]
    garbage = torch.randint(-32768, 32767, audio.shape, dtype=torch.int16,
                            device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    dirty = torch.where(t < lengths[:, None], audio, garbage)
    check(torch.equal(got, frontend.logmel_prefix(dirty, lengths, cfg)),
          "garbage past each length leaves the output unchanged (main batch)")
    bl = torch.tensor(BOUNDARY_LENGTHS, dtype=torch.int32, device="cuda")
    b_dirty = audio[: len(BOUNDARY_LENGTHS), :16000].contiguous()
    b_clean = torch.where(t[:, :16000] < bl[:, None], b_dirty, 0)
    b_got = frontend.logmel_prefix(b_dirty, bl, cfg)
    check(torch.equal(b_got, frontend.logmel_prefix(b_clean, bl, cfg)),
          f"boundary lengths {BOUNDARY_LENGTHS}: dirty tails == clean")
    check_prefix(testing, b_got, frontend.logmel_prefix_reference(b_clean, bl, cfg), M,
                 "boundary lengths")
    eps = torch.tensor(cfg.log_eps, dtype=torch.float32)
    check(bool((b_got[0, :, M] == eps.cuda()).all())
          and bool(torch.allclose(b_got[0, :, :M].cpu(), torch.log(eps), rtol=1e-6)),
          "length-0 row is the clamp constant")
    max_abs_err = errs["logmel_max_abs"]

    # 4. the main path, counted
    print(f"== 4. main path: chain.extract_batch({CONFIG}) on the card")
    frontend.launches = 0
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = frontend.launches
    check(launches > 0, f"front-end kernel launched on the main path ({launches})")
    check(tuple(feat.shape) == (B, F, cfg.feat_dim), f"features {tuple(feat.shape)}")
    check(feat.device.type == "cuda" and bool(torch.isfinite(feat).all()), "finite, on the card")
    check(bool((feat[mask == 0] == 0).all()) and int((mask == 0).sum()) > 0,
          f"pad frames exactly 0 ({int((mask == 0).sum())} of {B * F})")
    cpu_feat, cpu_mask = chain.extract_batch(batch.audio, batch.lengths, cfg, device="cpu")
    err_cpu = float((feat.cpu() - cpu_feat).abs().max())
    print(f"  max |card - cpu| = {err_cpu:.3e}")
    check(err_cpu <= testing.FEATURE_ATOL and torch.equal(mask.cpu(), cpu_mask),
          f"card within {testing.FEATURE_ATOL} of the CPU chain")
    f64, _ = chain.extract_batch(batch.audio[:4], batch.lengths[:4],
                                 cfg.replace(dtype="float64"), device="cpu")
    err64 = float((feat[:4].double().cpu() - f64).abs().max())
    print(f"  max |card - float64 chain| (rows 0-3) = {err64:.3e}")
    check(err64 <= testing.FEATURE_ATOL, f"card within {testing.FEATURE_ATOL} of the float64 plain chain")

    # 5. times
    print(f"== 5. times {tag}")
    kernel_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg), reps=10)
    st = chain.logmel_stages(audio, lengths, cfg)
    framed = torch.nn.functional.pad(st["windowed"].reshape(B * F, -1), (0, cfg.n_fft - cfg.frame_length))
    framed = framed.contiguous()
    del st
    rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, dim=-1))
    e2e_ms = cuda_ms(torch, lambda: chain.extract_batch(audio, lengths, cfg), reps=10)
    host = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain.extract_batch(batch.audio, batch.lengths, cfg)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = float(np.median(host))
    # where a device-resident step's time goes: kernels per step, device busy
    from torch.profiler import ProfilerActivity, profile

    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            chain.extract_batch(audio, lengths, cfg)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats its kernels'
    on_device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / steps
    ours_ms = sum(e.self_device_time_total for e in on_device
                  if "logmel_kernel" in e.name) / 1e3 / steps
    check(ours_ms > 0, "the profiler sees the front-end kernel on the card")

    # bound from this run's inputs: the samples and frames that need work
    lens = np.minimum(batch.lengths.astype(np.int64), T)
    samples = int(lens.sum())
    frames = int(sum(min(F, math.ceil(x / cfg.frame_step)) for x in lens))
    mel = chain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"]
    nnz = int((mel != 0).sum())
    Lk, N2 = min(cfg.frame_length, frontend.NFFT), frontend.NFFT // 2
    per_frame = (
        Lk  # window
        + 4 * N2 * int(math.log2(N2)) - 6 * N2 + 8  # 256-point complex FFT, split radix
        + 14 * (N2 // 2 - 1) + 2  # real split; its 1/2 scalings fold into pscale
        + 3 * (N2 - 1) + 2  # |X|^2 (bins 0 and 256 are real)
        + 2 * nnz  # mel over the nonzero weights (pscale folds into them)
        + N2 + 1  # energy: sum of 257 powers, times pscale
        + 2 * M + 1  # clamps and logs
    )
    ops = 2 * samples + frames * per_frame  # + pre-emphasis
    nbytes = samples * 2 + B * 4 + B * F * (M + 1) * 4 + (Lk + 257 * M + 2 * M + 512) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  bound: {nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us; {ops / 1e9:.3f} GFLOP "
          f"({frames} frames x {per_frame} + pre-emphasis) -> {t_ops * 1e3:.2f} us; "
          f"bound {bound_ms * 1e3:.2f} us by {bound_by}")
    print(f"  frontend kernel: {kernel_ms:.4f} ms ({bound_ms / kernel_ms * 100:.1f}% of bound) {tag}")
    print(f"  plain version (torch rfft chain on the card): {plain_ms:.4f} ms {tag}")
    print(f"  torch.fft.rfft on [{B * F}, {cfg.n_fft}] pre-framed (DFT only): {rfft_ms:.4f} ms {tag}")
    print(f"  extract_batch, inputs on the card: {e2e_ms:.4f} ms/step = "
          f"{B * SECONDS / (e2e_ms / 1e3):.0f} audio-s/s {tag}")
    print(f"  extract_batch, host int16 numpy in (H2D included, host clock): {host_ms:.3f} ms = "
          f"{B * SECONDS / (host_ms / 1e3):.0f} audio-s/s {tag}")
    print(f"  profiled step: {len(on_device) / steps:.0f} device kernels, device busy "
          f"{busy_ms:.4f} ms (front-end kernel {ours_ms:.4f} ms, the rest {busy_ms - ours_ms:.4f} ms); "
          f"idle {max(0.0, 1 - busy_ms / e2e_ms) * 100:.1f}% of the {e2e_ms:.4f} ms step {tag}")

    result = dict(KERNEL)
    result.update(
        launches=launches, max_abs_err=max_abs_err, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms,
    )
    print(card)
    print(json.dumps({"kernels": [result]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
