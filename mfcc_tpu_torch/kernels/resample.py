"""The polyphase resampler on Hopper: float32 [..., T] at sr_in →
[..., ceil(T·up/down)] at sr_out.

Port of `mfcc_tpu/kernels/resample.py::resample_pallas` (integer
decimation only on the TPU); the CUDA kernel (`csrc/resample.cu`, whose
header states its design and bound) takes every ratio whose tap table fits
its shared memory, with the polyphase FIR of `csrc/polyphase.cuh`.

`polyphase_resample` is the wrapper: on a CUDA float32 tensor it launches
the kernel or raises (other dtypes, a tap table over the budget); on a CPU
tensor it returns `resample_reference`, the plain two-dot torch version
(`ops.resample.resample_reference`). `launches` counts kernel launches (set
it to 0 to start a count).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mfcc_tpu_torch.kernels import _build
from mfcc_tpu_torch.ops import resample as R
from mfcc_tpu_torch.ops.resample import resample_reference  # noqa: F401

TILE_OUT = 2048  # outputs per block (csrc/resample.cu kTileOut)
SMEM_BUDGET_BYTES = 232448  # the H100's dynamic shared memory per block
MAX_BATCH = 65535  # grid.y limit: one grid row per utterance

launches = 0


def _align4(n: int) -> int:
    return (n + 3) & ~3


def input_span(n: int, d: dict) -> int:
    """Input samples that n consecutive outputs read (csrc/polyphase.cuh
    pp_input_span)."""
    return ((n - 1) * d["down"] + d["up"] - 1) // d["up"] + d["K"]


def smem_bytes(up: int, down: int) -> int:
    """Shared memory the kernel needs for this reduced ratio: the [up, K]
    tap table plus one tile's input window, float32."""
    d = R.polyphase_design(up, down)
    return (_align4(d["up"] * d["K"]) + input_span(TILE_OUT, d)) * 4


def check_budget(nbytes: int, what: str) -> None:
    if nbytes > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"{what} needs {nbytes:,} bytes of shared memory per block, over "
            f"the kernel's budget of {SMEM_BUDGET_BYTES:,} bytes"
        )


@functools.lru_cache(maxsize=16)
def device_table(up: int, down: int, scale: float, device: torch.device) -> torch.Tensor:
    table = R.polyphase_design(up, down)["table"] * scale
    return torch.as_tensor(table.astype(np.float32).ravel(), device=device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("resample")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_resample.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.mfcc_resample.restype = ctypes.c_int
    lib.mfcc_resample_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_resample_error_string.restype = ctypes.c_char_p
    return lib


def polyphase_resample(audio: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """audio [..., T] → [..., output_length(T)], scipy resample_poly with
    zero padding. CUDA tensors launch the kernel (float32, else it raises);
    CPU tensors get the plain version."""
    global launches
    if audio.device.type == "cpu":
        return resample_reference(audio, sr_in, sr_out)
    if audio.device.type != "cuda":
        raise ValueError(f"the resample kernel runs on CUDA, got {audio.device}")
    if audio.dtype != torch.float32:
        raise ValueError(
            f"the resample kernel computes in float32, got {audio.dtype}; "
            "resample float64 on the CPU"
        )
    if sr_in == sr_out:
        return audio
    up, down = R.ratio(sr_in, sr_out)
    check_budget(smem_bytes(up, down), f"the {sr_in} -> {sr_out} Hz tap table")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    n_in = audio.shape[-1]
    n_out = R.output_length(n_in, sr_in, sr_out)
    lead = audio.shape[:-1]
    if audio.numel() == 0:
        return audio.new_zeros(lead + (n_out,))
    x = audio.reshape(-1, n_in)
    B = x.shape[0]
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {MAX_BATCH} rows")
    out = torch.empty((B, n_out), dtype=torch.float32, device=audio.device)
    d = R.polyphase_design(up, down)
    table = device_table(up, down, 1.0, audio.device)
    lib = _lib()
    with torch.cuda.device(audio.device):
        rc = lib.mfcc_resample(
            x.data_ptr(), out.data_ptr(), table.data_ptr(), B, n_in, n_out,
            d["up"], d["down"], d["half_len"], d["K"],
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            "resample kernel launch failed: "
            f"{lib.mfcc_resample_error_string(rc).decode()} (cudaError {rc})"
        )
    launches += 1
    return out.reshape(lead + (n_out,))
