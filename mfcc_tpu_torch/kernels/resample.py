"""The polyphase resampler on Hopper: int16 or float32 [..., T] at sr_in →
float32 [..., ceil(T·up/down)] at sr_out.

Port of `mfcc_tpu/kernels/resample.py::resample_pallas` (integer
decimation only on the TPU); the CUDA kernel (`csrc/resample.cu`, whose
header states its design and bound) takes every ratio, with the polyphase
FIR of `csrc/polyphase.cuh`, by the `plan` this module mirrors: the tap
table and two tiles' windows staged at the largest tile that fits the
block (mode 0), the taps read from device memory where the table does not
fit (mode 1, "global_taps"), and the windows too where no tile's do (mode
2, "global_all").

`polyphase_resample` is the wrapper: on a CUDA float32 tensor it launches
the kernel or raises (other dtypes, non-contiguous rows); on a CPU tensor
it returns `resample_reference`, the plain two-dot torch version
(`ops.resample.resample_reference`). `resample_rows` is the first launch of
the front-end's split route: int16 or float32 rows with lengths, zeroed
past each length, → (float32 rows, output lengths), its plain version
`resample_rows_reference`. `launches` counts kernel launches;
`reduced_tile_launches`, `global_tap_launches` and `global_window_launches`
those that take a tile under TILE_OUT, mode 1 and mode 2 (set them to 0 to
start a count).
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
TILE_OUT = FIR_R1 * 256  # the largest tile: one group a thread of 256 (csrc/resample.cu kTileOut)
TILE_STEP = FIR_R1 * 32  # tiles are multiples of a warp's outputs (kTileStep)
MODES = ("staged", "global_taps", "global_all")  # csrc/resample.cu plan modes
SMEM_BUDGET_BYTES = 232448  # the H100's dynamic shared memory per block
MAX_TILES = 2**31 - 1  # tiles of all rows: the kernel's int tile index

launches = 0
reduced_tile_launches = 0
global_tap_launches = 0
global_window_launches = 0


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


def _layout_floats(d: dict, tile: int, mode: str, sample_bytes: int) -> int:
    """Floats of csrc/resample.cu's layout: the tap table (mode "staged"),
    two windows of `tile` outputs (`stage_floats` of the rows' samples; not
    in "global_all"), and the tile's output row."""
    table = _align4(d["up"] * table_stride(d)) if mode == "staged" else 0
    windows = 0 if mode == "global_all" else 2 * stage_floats(fir_window(tile, d), sample_bytes)
    return table + windows + tile


@functools.lru_cache(maxsize=64)
def plan(up: int, down: int) -> tuple[int, str]:
    """(outputs a tile, mode) of csrc/resample.cu for this reduced ratio,
    held to float32 windows so both row types take it: "staged" at the
    largest multiple of TILE_STEP up to TILE_OUT whose layout fits the
    block; else "global_taps" (the table read from device memory) at the
    largest whose windows fit; else "global_all" at TILE_OUT."""
    d = R.polyphase_design(up, down)
    tiles = range(TILE_OUT, TILE_STEP - 1, -TILE_STEP)
    for mode in MODES[:2]:
        for tile in tiles:
            if 4 * _layout_floats(d, tile, mode, 4) <= SMEM_BUDGET_BYTES:
                return tile, mode
    return TILE_OUT, "global_all"


def smem_bytes(up: int, down: int, int16: bool = False) -> int:
    """Shared memory a block of the kernel for this reduced ratio (its
    `plan`) with int16 or float32 rows (csrc/resample.cu layout): the tap
    table when staged, two tiles' input windows when staged (the current
    tile's and the next one's, copied while the current one is computed),
    and the tile's output row; never over SMEM_BUDGET_BYTES."""
    d = R.polyphase_design(up, down)
    tile, mode = plan(up, down)
    return 4 * _layout_floats(d, tile, mode, 2 if int16 else 4)


@functools.lru_cache(maxsize=16)
def device_table(up: int, down: int, scale: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(table(up, down, scale).ravel(), device=device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("resample")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mfcc_resample.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.mfcc_resample.restype = ctypes.c_int
    lib.mfcc_resample_kernel_info.argtypes = [i, i, i, i, i, i, i, p]
    lib.mfcc_resample_kernel_info.restype = ctypes.c_int
    lib.mfcc_resample_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_resample_error_string.restype = ctypes.c_char_p
    return lib


def kernel_info(sr_in: int, sr_out: int, int16: bool = False) -> dict:
    """The card's view of the kernel at this ratio and its plan, for int16
    or float32 rows (needs a card): registers and local (spilled) bytes a
    thread, blocks an SM and shared memory a block, from
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    with the plan's tile and mode."""
    up, down = R.ratio(sr_in, sr_out)
    d = R.polyphase_design(up, down)
    tile, mode = plan(up, down)
    out = (ctypes.c_int * 4)()
    rc = _lib().mfcc_resample_kernel_info(int(int16), d["up"], d["down"], d["half_len"], d["K"],
                                          tile, MODES.index(mode), out)
    if rc != 0:
        raise RuntimeError(f"resample kernel info failed: "
                           f"{_lib().mfcc_resample_error_string(rc).decode()} (cudaError {rc})")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "smem_bytes": out[3], "tile": tile, "mode": mode}


def resample_rows_reference(audio: torch.Tensor, lengths: torch.Tensor, sr_in: int,
                            sr_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`resample_rows`' plain version, on any device: the rows as float32,
    zeroed at t >= each length, by `resample_reference`, and the output
    lengths (`ops.resample.output_lengths`) — `chain.resample_input`'s
    steps."""
    t = torch.arange(audio.shape[-1], device=audio.device)
    x = audio.to(torch.float32) * (t[None, :] < lengths[:, None])
    return resample_reference(x, sr_in, sr_out), R.output_lengths(lengths, sr_in, sr_out)


def resample_rows(audio: torch.Tensor, lengths: torch.Tensor, sr_in: int,
                  sr_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [B, T] int16 or float32 at sr_in + lengths [B] int32 → (float32
    [B, output_length(T)] at sr_out, the input zeroed past each length, and
    the output lengths [B] int32, ceil(length·up/down)), both written by
    one launch on a CUDA tensor; the plain version on a CPU tensor. The
    first launch of the front-end's split route (`frontend.resample_route`)."""
    if audio.device.type == "cpu":
        y, n = resample_rows_reference(audio, lengths, sr_in, sr_out)
        return y, n.to(torch.int32)
    if audio.dim() != 2 or lengths.shape != audio.shape[:1] or lengths.dtype != torch.int32:
        raise ValueError(f"rows [B, T] and int32 lengths [B], got {tuple(audio.shape)} and "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    return _launch(audio, sr_in, sr_out, lengths)


def polyphase_resample(audio: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """audio [..., T] → [..., output_length(T)], scipy resample_poly with
    zero padding. CUDA tensors launch the kernel (float32, else it raises);
    CPU tensors get the plain version."""
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
    n_in = audio.shape[-1]
    lead = audio.shape[:-1]
    if audio.numel() == 0:
        return audio.new_zeros(lead + (R.output_length(n_in, sr_in, sr_out),))
    y, _ = _launch(audio.reshape(-1, n_in), sr_in, sr_out, None)
    return y.reshape(lead + (y.shape[-1],))


def _launch(x: torch.Tensor, sr_in: int, sr_out: int, lengths):
    """One launch on rows x [B, T] (int16 or float32, on a card) with
    optional int32 lengths → (y [B, n_out] float32, out lengths or None),
    counted."""
    global launches, reduced_tile_launches, global_tap_launches, global_window_launches
    if x.device.type != "cuda":
        raise ValueError(f"the resample kernel runs on CUDA, got {x.device}")
    if x.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"the resample kernel takes int16 or float32 rows, got {x.dtype}")
    if not x.is_contiguous() or (lengths is not None and (not lengths.is_contiguous()
                                                          or lengths.device != x.device)):
        raise ValueError("audio must be contiguous (and lengths contiguous, on its device)")
    B, n_in = x.shape
    up, down = R.ratio(sr_in, sr_out)
    n_out = R.output_length(n_in, sr_in, sr_out)
    y = torch.empty((B, n_out), dtype=torch.float32, device=x.device)
    out_len = None if lengths is None else torch.empty(B, dtype=torch.int32, device=x.device)
    if B == 0 or n_out == 0:
        return y, out_len
    tile, mode = plan(up, down)
    if -(-n_out // tile) * B > MAX_TILES:
        raise ValueError(f"{B} rows of {n_out} outputs exceed the kernel's {MAX_TILES} tiles")
    d = R.polyphase_design(up, down)
    table = device_table(up, down, 1.0, x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.mfcc_resample(
            x.data_ptr(), int(x.dtype == torch.int16), y.data_ptr(), table.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            None if out_len is None else out_len.data_ptr(), B, n_in, n_out,
            d["up"], d["down"], d["half_len"], d["K"], tile, MODES.index(mode),
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            "resample kernel launch failed: "
            f"{lib.mfcc_resample_error_string(rc).decode()} (cudaError {rc})"
        )
    launches += 1
    reduced_tile_launches += int(tile < TILE_OUT)
    global_tap_launches += int(mode != "staged")
    global_window_launches += int(mode == "global_all")
    return y, out_len
