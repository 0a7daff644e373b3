#!/usr/bin/env python3
"""The front-end's block FFT plan at each of its (tables, groups) choices, on
one CUDA card.

    python3 scripts/block_plan_sweep.py

csrc/frontend.cu's plan_block takes the first of 4, 2 and 1 groups (frames
a block transforms at once) with the tables staged, then with them in
device memory, whose layout fits the block. This script builds the source
six times, each with plan_block's search started at another choice (it
then takes the first that fits from there), binds each build as the
wrapper's library, and times the front-end kernel (profiler device time, L2
flushed before every launch, `chip_smoke.device_ms`) at each choice in
turns (forward, then backward) beside torch.fft.rfft(n=n_fft) on the same
windowed frames: classic13 at n_fft 1102, 4096, 2501 and 2160, b16 x 10 s,
and librosa's framing (logmel80 at 22.05 kHz, n_fft 2048, hop 512, 128
mels) at b64 x 10 s, int16 rows. Each choice's output is held to the
default build's within the kernel-vs-plain gates. Prints the choice taken,
its shared memory and blocks an SM (from the layout mirror), the card's
name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
# plan_block's search, whose starting point each build moves
SEARCH = """  for (int global = 0; global < 2; ++global) {
    for (int groups = 4; groups >= 1; groups /= 2) {"""
STARTS = ((0, 4), (0, 2), (0, 1), (1, 4), (1, 2), (1, 1))  # (tables in device memory, groups)
PATHS = (("classic13", 1102, 16), ("classic13", 4096, 16), ("classic13", 2501, 16),
         ("classic13", 2160, 16), ("librosa", 2048, 64))
LIBROSA = dict(sample_rate=22050, n_fft=2048, win_len_s=2048 / 22050, hop_s=512 / 22050, n_mels=128)


def variant(src: str, start: tuple[int, int]) -> str:
    """csrc/frontend.cu with plan_block's search started at `start`."""
    assert src.count(SEARCH) == 1, "plan_block's search not found"
    g, n = start
    return src.replace(SEARCH, f"""  for (int global = {g}; global < 2; ++global) {{
    for (int groups = {n}; groups >= 1; groups /= 2) {{""")


def taken(frontend, cfg, start: tuple[int, int]) -> tuple[str, int, int, int]:
    """(plan, groups, bytes, blocks an SM by shared memory) that a build
    whose search starts at `start` takes for cfg (the layout mirror)."""
    order = list(frontend.FFT_LAYOUTS[1:])
    first = order.index(("block_global" if start[0] else "block", start[1]))
    form = frontend.dft_form(cfg)
    for plan, groups in order[first:]:
        n = frontend._fft_smem(cfg, form, plan, True, groups)
        if n <= frontend.rs_kernel.SMEM_BUDGET_BYTES:
            return plan, groups, n, 233472 // (n + 1024)
    raise ValueError("no block plan fits")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("block_plan_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import _build, frontend
    from mfcc_tpu_torch.pipeline import pad_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    src = (_build.CSRC / "frontend.cu").read_text()
    out = _build.BUILD_DIR / "block_plan_sweep"
    out.mkdir(parents=True, exist_ok=True)

    def build(start):
        cu = out / f"start{start[0]}{start[1]}.cu"
        cu.write_text(variant(src, start))
        so = cu.with_suffix(".so")
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                              str(cu)], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed on {cu}:\n{res.stderr[-3000:]}")
        return so

    with concurrent.futures.ThreadPoolExecutor(len(STARTS)) as pool:
        sos = dict(zip(STARTS, pool.map(build, STARTS)))
    whole = frontend._lib()
    libs = {}
    for start, so in sos.items():
        lib = ctypes.CDLL(str(so))
        for name in ("mfcc_frontend_logmel", "mfcc_frontend_error_string"):
            getattr(lib, name).argtypes = getattr(whole, name).argtypes
            getattr(lib, name).restype = getattr(whole, name).restype
        libs[start] = lib
    print(f"block plan sweep [{card}]")
    own = frontend._lib
    for name, n_fft, rows in PATHS:
        cfg = (named_config("logmel80").replace(**LIBROSA) if name == "librosa"
               else named_config(name).replace(n_fft=n_fft))
        n = cfg.sample_rate * 10
        g = np.random.default_rng(3)
        utts = [(g.standard_normal(n - 571 * i) * 3000).astype(np.int16) for i in range(rows)]
        batch = pad_batch(utts, cfg, bucket_len=n, dtype="int16")
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda")
        want = frontend.logmel_prefix(audio, lengths, cfg)
        ms = {start: [] for start in STARTS}
        try:
            for start in STARTS + STARTS[::-1]:
                frontend._lib = lambda start=start: libs[start]
                errs = testing.prefix_errors(frontend.logmel_prefix(audio, lengths, cfg), want, cfg.n_mels,
                                             cfg.log_kind)
                if testing.prefix_failures(errs):
                    raise SystemExit(f"{name} {n_fft} from {start}: {errs}")
                ms[start].append(chip_smoke.device_ms(
                    torch, lambda: frontend.logmel_prefix(audio, lengths, cfg), "logmel_kernel"))
        finally:
            frontend._lib = own
        st = frontend.chain.logmel_stages(audio, lengths, cfg)
        framed = st["windowed"].reshape(rows * st["windowed"].shape[1], -1).contiguous()
        del st
        rfft_ms = chip_smoke.device_ms(torch, lambda: torch.fft.rfft(framed, n=cfg.n_fft, dim=-1))
        print(f"{name} n_fft {n_fft} b{rows} x 10 s: rfft(n={n_fft}) {rfft_ms:.4f} ms of device time; "
              f"default {frontend.fft_layout(cfg)}")
        for start in STARTS:
            plan, groups, nbytes, blocks = taken(frontend, cfg, start)
            mean = float(np.mean(ms[start]))
            print(f"  search from {start}: {plan}, {groups} frames a block at once, {nbytes:,} B, {blocks} "
                  f"blocks an SM: {mean:.4f} ms ({ms[start][0]:.4f}, {ms[start][1]:.4f}), "
                  f"{mean / rfft_ms:.2f}x rfft")
        del audio, lengths, framed
    return 0


if __name__ == "__main__":
    sys.exit(main())
