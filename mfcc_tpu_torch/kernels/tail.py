"""The cepstral feature tail on Hopper: [log-mel | energy] prefix → finished
MFCC features.

Port of `mfcc_tpu/kernels/frontend.py::_make_feature_tail` (the in-kernel
epilogue of `fused_logmel_stages(feature_tail=True)`). The CUDA kernel
(`csrc/tail.cu`, whose header states its design and bound) takes the
front-end's [B, F, n_mels+1] prefix and the valid frame counts and writes
[B, F, feat_dim]: the log of the energy lane (floored), one DCT·lifter·c0
product with `constants.dct_augmented`, Δ and ΔΔ with replication at each
utterance's last valid frame, the mask, and utterance CMVN (a second launch)
when cfg.cmvn is "utterance". Global CMVN is corpus-level and not applied,
as in the chain.

Unlike the reference, whose tail needs the whole utterance in one frame
block of its TPU layout (`fused_tail_active`), the kernel takes any frame
count: a tile of 128 frames stages its own halo of 2·deltas·delta_window
frames. The named shapes (`fixed_shape`) are compiled with their sizes
fixed and dct_aug in the kernel's parameters; any other shape takes the
kernel's generic instantiation, at the first of 128, 64 or 32 frames a
block whose layout fits; where none fits (wide cepstra: 170 at delta
window 8, 200 at 40) the split plan, 1 + deltas passes through the output
in device memory (`plan`), its base pass past CHAIN_LANES filters a kernel
of its own (`split_base`: tiles of BASE_TILE frames, each warp a
compensated (Kahan) sum over every lane of its stretches of STRETCH lanes,
the warps' sums added in float64). So the tail takes every mfcc config, as
the reference's jnp tail does.

`feature_tail` is the wrapper: on a CUDA tensor it launches the kernel or
raises; on a CPU tensor it returns `feature_tail_reference`, the plain
PyTorch version (the prefix branch of `chain.features_from_logmel`).
`tail_launches` counts calls that launch the tail (one a call, whatever
its plan), `tail_split_launches` the kernels the split plan launches (its
1 + deltas passes, each counted), `tail_base_launches` those of them that
are the base kernel past CHAIN_LANES filters, `tail_cmvn_launches` the
launches of its CMVN pass; set them to 0 to start a count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.kernels import _build
from mfcc_tpu_torch.kernels import resample as rs_kernel
from mfcc_tpu_torch.ops import chain

TILES = (128, 64, 32)  # frames per block (csrc/tail.cu kTileMax; the generic shape may halve it)
# the generic shape's plans (csrc/tail.cu TailParams::split), in the order tried
MODES = ("staged", "split")
MAX_BATCH = 65535  # grid.y limit: one grid row per utterance
# (n_mels + 1, n_ceps, delta_window or None, deltas) compiled with fixed sizes
# (csrc/tail.cu shape_of); delta_window None: any (no deltas)
FIXED_SHAPES = ((27, 13, 2, 2), (27, 13, None, 0), (24, 13, None, 0))
# the split's base (csrc/tail.cu): one FMA chain a (row, column) up to
# CHAIN_LANES lanes (kChainLanes); past it tail_base_kernel, BASE_TILE frames
# and BASE_COLS cepstra a block, 8 warps, warp w summing stretches w, w + 8,
# ... of STRETCH lanes (kBaseTile, kBaseCols, kStretch)
CHAIN_LANES = 1024
BASE_TILE = 64
BASE_COLS = 16
STRETCH = 256
BASE_WARPS = 8

tail_launches = 0
tail_split_launches = 0
tail_base_launches = 0
tail_cmvn_launches = 0


def fixed_shape(cfg: FrontendConfig) -> bool:
    """True when cfg's tail shape is one the kernel is compiled for with its
    sizes fixed (the named mfcc configs'); the others take the generic
    instantiation."""
    M1, C, N, nd = cfg.n_mels + 1, cfg.n_ceps, cfg.delta_window, cfg.deltas
    return any(M1 == m and C == c and nd == d and (n is None or N == n)
               for m, c, n, d in FIXED_SHAPES)


def _a4(n: int) -> int:
    return (n + 3) & ~3


def _floats(cfg: FrontendConfig, tile: int) -> int:
    """Floats of one tail block at `tile` frames (csrc/tail.cu tail_layout):
    dct_aug for the generic shape, the staged prefix rows with their halo of
    deltas·delta_window frames on each side at the odd row stride M1 | 1
    (and 6 floats of alignment slack), which ΔΔ [tile, C] overlays, their
    base cepstra, and D."""
    M1, C, N, nd = cfg.n_mels + 1, cfg.n_ceps, cfg.delta_window, cfg.deltas
    N = N if nd > 0 else 0
    R = tile + 2 * nd * N
    RD = 0 if nd == 0 else tile + 2 * (N if nd >= 2 else 0)
    w = 0 if fixed_shape(cfg) else _a4(M1 * C)
    return w + _a4(max(R * (M1 | 1) + 6, tile * C)) + R * C + RD * C


def plan(cfg: FrontendConfig) -> tuple[str, int, int]:
    """(plan of `MODES`, frames a block, shared-memory bytes a block) of
    cfg's tail (csrc/tail.cu plan_tail): "staged" at 128 frames for a fixed
    shape; for the generic one the first of 128, 64 and 32 frames whose
    layout fits the block ("staged"); else "split" (no tile, no shared
    memory: base, then Δ and ΔΔ, each a pass through the output)."""
    if fixed_shape(cfg):
        return "staged", TILES[0], 4 * _floats(cfg, TILES[0])
    for tile in TILES:
        n = 4 * _floats(cfg, tile)
        if n <= rs_kernel.SMEM_BUDGET_BYTES:
            return "staged", tile, n
    return "split", 0, 0


def split_base(cfg: FrontendConfig) -> str | None:
    """How the split plan sums base (None for the tiled plans): "chain", one
    FMA chain a (row, column) in lane order, the tiled kernel's; "stretches"
    past CHAIN_LANES filters, tail_base_kernel's: each warp a compensated
    (Kahan) sum over every lane of its stretches of STRETCH lanes, the warps'
    sums added in float64."""
    if plan(cfg)[0] != "split":
        return None
    return "stretches" if cfg.n_mels > CHAIN_LANES else "chain"


def smem_bytes(cfg: FrontendConfig) -> int:
    """Shared memory of one tail block (`plan`)."""
    return plan(cfg)[2]


def tail_reason(cfg: FrontendConfig) -> str | None:
    """None when the feature-tail kernel computes cfg's features; otherwise
    why not (port of `fused_tail_reason`, without its 128-lane limits, which
    are a TPU layout, and without its frame-block and layout limits: a plan
    of `plan` takes every mfcc shape)."""
    if cfg.features != "mfcc":
        return "the feature tail is the mfcc cepstral epilogue only"
    return None


def feature_tail_reference(
    prefix: torch.Tensor,
    n_valid: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The kernel's plain version, on any device: `chain.features_from_logmel`
    on the prefix stage dict (one matmul with dct_aug, `chain.delta`, the
    mask, `chain.cmvn_utterance`)."""
    stages = {
        "prefix": prefix,
        "n_valid": n_valid,
        "frame_mask": chain.frame_mask(n_valid, prefix.shape[1], prefix.dtype),
    }
    return chain.features_from_logmel(stages, cfg, consts)


@functools.lru_cache(maxsize=16)
def _host_dct(cfg: FrontendConfig) -> torch.Tensor:
    """dct_aug [M1, C] float32 in host memory: the fixed shapes' launch
    copies it into the kernel's parameters."""
    aug = chain.device_constants(cfg, torch.device("cpu"), torch.float64)["dct_aug"]
    return aug.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=16)
def _device_dct(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    return _host_dct(cfg).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("tail")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mfcc_feature_tail.argtypes = [
        p, p, p, p, p,  # prefix, n_valid, dct, its host copy, out
        i, i, i, i, i, i,  # B, F, M1, C, deltas, N
        i, i, f, f, f,  # append_energy, has_floor, eps, log_floor, denom
        p,  # stream
    ]
    lib.mfcc_feature_tail.restype = ctypes.c_int
    lib.mfcc_feature_tail_cmvn.argtypes = [p, p, i, i, i, i, f, p]
    lib.mfcc_feature_tail_cmvn.restype = ctypes.c_int
    lib.mfcc_tail_error_string.argtypes = [ctypes.c_int]
    lib.mfcc_tail_error_string.restype = ctypes.c_char_p
    return lib


def _check(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.mfcc_tail_error_string(rc).decode()} "
                           f"(cudaError {rc})")


def feature_tail(
    prefix: torch.Tensor,
    n_valid: torch.Tensor,
    cfg: FrontendConfig,
    consts: dict[str, torch.Tensor] | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """prefix [B, F, n_mels+1] float32 ([log-mel | clamped energy]) +
    n_valid [B] int32 → features [B, F, feat_dim] float32, rows past each
    n_valid exactly 0.

    CUDA tensors launch the kernel (contiguous, on one device, else it
    raises); CPU tensors get the plain version. `consts` overrides dct_aug
    (a chain-constants dict). `out`, a contiguous float32 [B, F, feat_dim]
    tensor on prefix's device, receives the features (the streaming round
    writes both window kinds into one buffer)."""
    global tail_launches, tail_split_launches, tail_base_launches, tail_cmvn_launches
    if out is not None and (out.shape != (*prefix.shape[:2], cfg.feat_dim)
                            or out.dtype != torch.float32 or out.device != prefix.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous float32 [{prefix.shape[0]}, {prefix.shape[1]}, "
                         f"{cfg.feat_dim}] on {prefix.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if prefix.device.type == "cpu":
        feat = feature_tail_reference(prefix, n_valid, cfg, consts)
        return feat if out is None else out.copy_(feat)
    if prefix.device.type != "cuda":
        raise ValueError(f"the feature-tail kernel runs on CUDA, got {prefix.device}")
    reason = tail_reason(cfg)
    if reason:
        raise NotImplementedError(f"config {cfg.config_hash()}: {reason}")
    M1 = cfg.n_mels + 1
    if prefix.dim() != 3 or prefix.dtype != torch.float32 or prefix.shape[-1] != M1:
        raise ValueError(
            f"prefix must be [B, F, {M1}] float32, got {prefix.dtype} {tuple(prefix.shape)}"
        )
    B, F, _ = prefix.shape
    if n_valid.device != prefix.device or n_valid.dtype != torch.int32 or n_valid.shape != (B,):
        raise ValueError(
            f"n_valid must be int32 [{B}] on {prefix.device}, got {n_valid.dtype} "
            f"{tuple(n_valid.shape)} on {n_valid.device}"
        )
    if not (prefix.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("prefix and n_valid must be contiguous")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's {MAX_BATCH} rows")
    if out is None:
        out = torch.empty((B, F, cfg.feat_dim), dtype=torch.float32, device=prefix.device)
    if B == 0 or F == 0:  # F = 0: "drop" framing of rows shorter than a frame
        return out
    if consts is None:
        dct, host = _device_dct(cfg, prefix.device), _host_dct(cfg)
    else:
        dct = consts["dct_aug"].to(device=prefix.device, dtype=torch.float32).contiguous()
        host = dct.cpu()
    N = cfg.delta_window
    lib = _lib()
    with torch.cuda.device(prefix.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mfcc_feature_tail(
            prefix.data_ptr(), n_valid.data_ptr(), dct.data_ptr(), host.data_ptr(), out.data_ptr(),
            B, F, M1, cfg.n_ceps, cfg.deltas, N, int(cfg.append_energy),
            int(cfg.energy_floor > 0.0), cfg.log_eps,
            math.log(cfg.energy_floor) if cfg.energy_floor > 0.0 else 0.0,
            2.0 * sum(i * i for i in range(1, N + 1)), stream,
        )
        _check(rc, lib, "feature-tail kernel")
        tail_launches += 1
        if plan(cfg)[0] == "split":
            tail_split_launches += 1 + cfg.deltas
            tail_base_launches += int(split_base(cfg) == "stretches")
        if cfg.cmvn == "utterance":
            rc = lib.mfcc_feature_tail_cmvn(
                out.data_ptr(), n_valid.data_ptr(), B, F, cfg.feat_dim,
                int(cfg.cmvn_var_norm), cfg.cmvn_eps, stream,
            )
            _check(rc, lib, "feature-tail CMVN")
            tail_cmvn_launches += 1
    return out
