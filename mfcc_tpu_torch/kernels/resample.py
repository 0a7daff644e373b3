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

FIR_R1 = 7  # consecutive outputs a thread at up = 1 (csrc/polyphase.cuh kPpR1)
FIR_RU = 4  # outputs a thread, up apart, at up > 1 (kPpRU)
TILE_OUT = FIR_R1 * 256  # outputs a tile: one group a thread of 256 (csrc/resample.cu kTileOut)
SMEM_BUDGET_BYTES = 232448  # the H100's dynamic shared memory per block
MAX_TILES = 2**31 - 1  # tiles of all rows: the kernel's int tile index

launches = 0


def _align4(n: int) -> int:
    return (n + 3) & ~3


def table_stride(d: dict) -> int:
    """Taps a row of the staged table (csrc/polyphase.cuh pp_stride): at
    up = 1 K rounded up to a multiple of down * FIR_R1 (equal residue
    classes, each whole steps of FIR_R1), at up > 1 K rounded up to odd
    (bank-distinct rows)."""
    if d["up"] == 1:
        block = d["down"] * FIR_R1
        return -(-d["K"] // block) * block
    return d["K"] | 1


def fir_taps(d: dict) -> int:
    """Taps an output reads (pp_taps): the padded row at up = 1, K else."""
    return table_stride(d) if d["up"] == 1 else d["K"]


def first_input(j: int, d: dict) -> int:
    """Lowest input index outputs from j on read (pp_first_input)."""
    return (j * d["down"] + d["half_len"]) // d["up"] - (fir_taps(d) - 1)


def input_span(n: int, d: dict) -> int:
    """Input samples that n consecutive outputs read (csrc/polyphase.cuh
    pp_input_span)."""
    return ((n - 1) * d["down"] + d["up"] - 1) // d["up"] + fir_taps(d)


def fir_window(n: int, d: dict) -> int:
    """The window the FIR reads for n outputs (pp_window): at up = 1 the
    last thread's FIR_R1 outputs may run past n."""
    return input_span(-(-n // FIR_R1) * FIR_R1 if d["up"] == 1 else n, d)


def stage_floats(n: int, sample_bytes: int = 4) -> int:
    """Floats of shared memory a staged window of n samples takes
    (pp_stage_floats): n rounded up to whole 16-byte vectors, plus one
    vector for the shift to the 16-byte boundary below its first sample."""
    v = 16 // sample_bytes
    return (-(-n // v) * v + v) * sample_bytes // 4


def table(up: int, down: int, scale: float = 1.0) -> np.ndarray:
    """The staged tap table, float32 [up, table_stride]: polyphase_design's
    rows times `scale`, rounded once, zeros past K."""
    d = R.polyphase_design(up, down)
    t = np.zeros((d["up"], table_stride(d)), dtype=np.float32)
    t[:, : d["K"]] = d["table"] * scale
    return t


def smem_bytes(up: int, down: int) -> int:
    """Shared memory the kernel needs for this reduced ratio (csrc/resample.cu
    layout): the tap table, two tiles' input windows (`stage_floats`: the
    current tile's and the next one's, copied while the current one is
    computed), and the tile's output row, float32."""
    d = R.polyphase_design(up, down)
    return (_align4(d["up"] * table_stride(d)) + 2 * stage_floats(fir_window(TILE_OUT, d))
            + TILE_OUT) * 4


def check_budget(nbytes: int, what: str) -> None:
    if nbytes > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"{what} needs {nbytes:,} bytes of shared memory per block, over "
            f"the kernel's budget of {SMEM_BUDGET_BYTES:,} bytes"
        )


@functools.lru_cache(maxsize=16)
def device_table(up: int, down: int, scale: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(table(up, down, scale).ravel(), device=device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("resample")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_resample.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.mfcc_resample.restype = ctypes.c_int
    lib.mfcc_resample_kernel_info.argtypes = [i, i, i, i, p]
    lib.mfcc_resample_kernel_info.restype = ctypes.c_int
    lib.mfcc_resample_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_resample_error_string.restype = ctypes.c_char_p
    return lib


def kernel_info(sr_in: int, sr_out: int) -> dict:
    """The card's view of the kernel at this ratio (needs a card):
    registers and local (spilled) bytes a thread, blocks an SM and shared
    memory a block, from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    d = R.polyphase_design(*R.ratio(sr_in, sr_out))
    out = (ctypes.c_int * 4)()
    rc = _lib().mfcc_resample_kernel_info(d["up"], d["down"], d["half_len"], d["K"], out)
    if rc != 0:
        raise RuntimeError(f"resample kernel info failed: "
                           f"{_lib().mfcc_resample_error_string(rc).decode()} (cudaError {rc})")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "smem_bytes": out[3]}


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
    if -(-n_out // TILE_OUT) * B > MAX_TILES:
        raise ValueError(f"{B} rows of {n_out} outputs exceed the kernel's {MAX_TILES} tiles")
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
