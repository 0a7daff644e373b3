#!/usr/bin/env python3
"""The front-end's block FFT plan at each of its (plan, groups) choices, on
one CUDA card; or this checkout's kernels against another checkout's, in
turns.

    python3 scripts/block_plan_sweep.py
    python3 scripts/block_plan_sweep.py --parent DIR [--bf16x3]
    python3 scripts/block_plan_sweep.py --wide-tiles
    python3 scripts/block_plan_sweep.py --wide-rule

csrc/frontend.cu's plan_block takes the first plan of its ladder (block,
block_global, gather, gather_global, gather_bands, gather_rows,
gather_sums: kernels/frontend.py BLOCK_LADDER, PLAN_TRAITS; the cluster
plan and the wide plan are no rungs of it, a launch asks for them) at the first of 4, 2 and 1 groups (frames
a block transforms at once) whose layout fits the block. This script builds
the source once for each of `STARTS`, each with plan_block's search started
at another choice (it then takes the first that fits from there: a start
in the last two plans forces them), binds each build as the wrapper's
library, and times the front-end kernel (profiler device time, L2 flushed
before every launch, `chip_smoke.device_ms`) at each choice in turns
(forward, then backward) beside torch.fft.rfft(n=n_fft) on the same
windowed frames: classic13 at n_fft 1102, 4096, 2501 and 2160, b16 x 10 s,
and librosa's framing (logmel80 at 22.05 kHz, n_fft 2048, hop 512, 128
mels) at b64 x 10 s, int16 rows. Each choice's output is held to the
default build's within the kernel-vs-plain gates. Prints the choice taken,
its shared memory and blocks an SM (from the layout mirror), the card's
name and power limit. Imports nothing of JAX.

With --parent DIR it builds `frontend.cu` and `tail.cu` of this checkout and
of the checkout at DIR (their C interfaces the same; a parent whose packed
mel table carries each weight's filter, bin | filter << 16, is given that
table), binds each build as the wrapper's library in turn, and times each kernel (profiler device time,
L2 flushed before every call; the tail's every kernel of the call) in the order
parent, change, change, parent: the front-end at `TURNS` (classic13_deltas
b64 x 10 s in the warp plan; classic13 at n_fft 1102, 4096 and 2501 b16 x
10 s and librosa's framing b64 x 10 s in the block plan; classic13_deltas
b16 x 10 s at hop 0.2 s in the gather plan, at n_fft 6001 in
"gather_global"; at 16,384 and 32,768, 13,001 (Bluestein), 65,536 at 48
kHz b4 x 30 s, 131,072 b2 x 30 s and librosa's 16,384 at 44.1 kHz b64 x
30 s, the cluster plan's sizes ("gather_bands" or "gather_rows" in the
parent); kaldi_mfcc with dither at n_fft 1102 b16 x 10 s, the block
plan's dither and conditioning instantiation; the fused resample at
mfcc39_48k b64 x 10 s; tens of thousands of filters, the wide plan's cases
("gather_sums" or "gather_bands" in the parent): classic13_deltas at 60,000
and 40,000 filters b16 x 10 s, ssc26 at 30,000 filters and n_fft 4,096 b16,
logmel80 at 33,000 filters b4; a parent from before the cluster plan or the
wide plan given the ladder without them, its entry without their
arguments), each size the
cluster plan takes also at every other cluster size that fits, in turns
with its default (the size is a launch argument: no rebuild), the feature tail
at `TAIL_TURNS` (classic13_deltas at 170 cepstra and delta window 8 and at
200 and window 40, b16 x 10 s, and at 60,000 filters, the base kernel past
1,024 lanes against the parent's compensated split, on this checkout's
front-end prefix). Each
build's output is held to the other's within the kernel-vs-plain gates.
Prints both means, their ratio, the plans and whether the outputs are
equal bitwise. Then it
builds this checkout's frontend.cu forced to "gather_bands", "gather_rows"
and "gather_sums" (`FORCED`, one group each) and times each in turns with
the default build at `FORCED_AT` (classic13_deltas at n_fft 6001, b16 x 10
s, where "gather_global" at one group fits), printing whether the outputs
are equal bitwise: the three plans move operands to device memory and
change no arithmetic. The bf16x3 form is timed the same way, in turns with
the parent's, at `BF16X3_TURNS`: its staged plan (classic13 b64 x 10 s) and
fused resample (mfcc39_48k b64 x 10 s), and, where the parent has them, its
block plans at each of their layouts (classic13_deltas at n_fft 4,096 b64;
a 0.1 s hop, 1.1 s frames, 10 ms frames at n_fft 4,096 and n_fft 32,768;
librosa's 8,192-point framing b16 x 30 s; 2,000 and 40,000 filters).
--bf16x3 builds the two checkouts' frontend.cu alone and times only those.

With --wide-tiles it times this checkout's wide plan at each tile of
`WIDE_TILES` that fits and at the launch's own (`frontend.wide_tile`), the
tile a launch argument (no rebuild), in turns (forward, then backward), at
the wide plan's cases of `TURNS`, each output bitwise the default launch's.

With --wide-rule it times this checkout's wide plan forced (its layout's
tile, the launch's `frontend.wide_tile`) against the plan the ladder gives
without it (`frontend.fft_layout(wide=False)`), in turns (ladder, wide,
wide, ladder), at `RULE_TURNS`: the many-filter configs around
`frontend.WIDE_MIN_FILTERS`, where "gather_bands" is first taken at n_fft
512 (14,172 filters), just below and just above 16,384, kaldi_mfcc at
33,000 b4, and at n_fft 8,192 (9,815 filters, where it is first taken
there, and 33,000), each pair's outputs within the kernel-vs-plain gates,
printing whether their lanes [0, M) are equal bitwise.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
# plan_block's search, whose starting point each build moves
SEARCH = """  for (int plan = 0; plan < 7; ++plan) {
    for (int groups = 4; groups >= 1; groups /= 2) {"""
# (plan of the ladder, kernels/frontend.py BLOCK_LADDER[plan]; groups)
STARTS = ((0, 4), (0, 2), (0, 1), (1, 4), (1, 2), (1, 1), (4, 1), (5, 4))
PATHS = (("classic13", 1102, 16), ("classic13", 4096, 16), ("classic13", 2501, 16),
         ("classic13", 2160, 16), ("librosa", 2048, 64))
LIBROSA = dict(sample_rate=22050, n_fft=2048, win_len_s=2048 / 22050, hop_s=512 / 22050, n_mels=128)
LIBROSA_8192 = dict(sample_rate=22050, n_fft=8192, win_len_s=8192 / 22050, hop_s=2048 / 22050, n_mels=128)
# librosa's melspectrogram(sr=44100, n_fft=16384, hop_length=4096,
# n_mels=128) framing (chip_smoke.py LIBROSA_16384)
LIBROSA_16384 = dict(sample_rate=44100, n_fft=16384, win_len_s=16384 / 44100, hop_s=4096 / 44100, n_mels=128,
                     mel_variant="librosa_hz", mel_scale="slaney", mel_norm="slaney", mel_low_hz=0.0,
                     mel_high_hz=22050.0)
# --parent: (config, overrides, rows[, seconds a row: 10]) of the front-end
# and of the tail; the cluster plan's cases (chip_smoke.py phase 29's) also
# at each cluster size that fits, in turns with the default
TURNS = (("classic13_deltas", {}, 64), ("classic13", dict(n_fft=1102), 16), ("classic13", dict(n_fft=4096), 16),
         ("classic13", dict(n_fft=2501), 16), ("logmel80", LIBROSA, 64),
         ("classic13_deltas", dict(hop_s=0.2), 16), ("classic13_deltas", dict(n_fft=6001), 16),
         ("classic13_deltas", dict(n_fft=16384), 16), ("classic13_deltas", dict(n_fft=32768), 16),
         ("classic13_deltas", dict(n_fft=13001), 16), ("classic13_deltas", dict(sample_rate=48000, n_fft=65536), 4, 30),
         ("classic13_deltas", dict(n_fft=131072), 2, 30), ("logmel80", LIBROSA_16384, 64, 30),
         ("kaldi_mfcc", dict(n_fft=1102, dither=1.0), 16), ("mfcc39_48k", {}, 64),
         ("classic13_deltas", dict(n_mels=60000), 16), ("ssc26", dict(n_mels=30000, n_fft=4096), 16),
         ("classic13_deltas", dict(n_mels=40000), 16), ("logmel80", dict(n_mels=33000), 4))
TAIL_TURNS = (("classic13_deltas", dict(n_mels=170, n_ceps=170, delta_window=8), 16),
              ("classic13_deltas", dict(n_mels=200, n_ceps=200, delta_window=40), 16),
              ("classic13_deltas", dict(n_mels=60000), 16))
# --parent: (config, overrides, rows[, seconds a row: 10]) of the bf16x3
# form: its staged plan and fused resample, then (where the parent has them)
# its block plans at each layout
BF16X3_TURNS = (("classic13", {}, 64), ("mfcc39_48k", {}, 64), ("classic13_deltas", dict(n_fft=4096), 64),
                ("classic13_deltas", dict(hop_s=0.1), 16), ("classic13_deltas", dict(win_len_s=1.1), 16),
                ("classic13_deltas", dict(win_len_s=0.01, n_fft=4096), 16),
                ("classic13_deltas", dict(n_fft=32768), 4), ("logmel80", LIBROSA_8192, 16, 30),
                ("classic13_deltas", dict(n_mels=2000, n_fft=4096), 4),
                ("classic13_deltas", dict(n_mels=40000), 16))
FRONTEND_FNS = ("mfcc_frontend_logmel", "mfcc_frontend_logmel_resample", "mfcc_frontend_error_string",
                "mfcc_frontend_kernel_info", "mfcc_frontend_cluster_info", "mfcc_frontend_wide_info")
# --wide-tiles: the wide plan's tiles (frames a block) timed beside the launch's
WIDE_TILES = (4, 8, 16, 32, 64, 93)
# --wide-rule: (config, overrides, rows) where the wide plan is timed
# against the ladder's plan without it
RULE_TURNS = (("classic13_deltas", dict(n_mels=14172), 16), ("classic13_deltas", dict(n_mels=16383), 16),
              ("classic13_deltas", dict(n_mels=16385), 16), ("logmel80", dict(n_mels=14172), 4),
              ("kaldi_mfcc", dict(n_mels=33000), 4), ("classic13_deltas", dict(n_mels=9815, n_fft=8192), 16),
              ("classic13_deltas", dict(n_mels=33000, n_fft=8192), 16))
# --parent: the plans forced at one group, and the config they are forced at
FORCED = (("gather_bands", (4, 1)), ("gather_rows", (5, 1)), ("gather_sums", (6, 1)))
FORCED_AT = ("classic13_deltas", dict(n_fft=6001), 16)
TAIL_FNS = ("mfcc_feature_tail", "mfcc_feature_tail_cmvn", "mfcc_tail_error_string")


def variant(src: str, start: tuple[int, int]) -> str:
    """csrc/frontend.cu with plan_block's search started at `start`."""
    assert src.count(SEARCH) == 1, "plan_block's search not found"
    plan, n = start
    return src.replace(SEARCH, f"""  for (int plan = {plan}; plan < 7; ++plan) {{
    for (int groups = {n}; groups >= 1; groups /= 2) {{""")


def taken(frontend, cfg, start: tuple[int, int]) -> tuple[str, int, int, int]:
    """(plan, groups, bytes, blocks an SM by shared memory) that a build
    whose search starts at `start` takes for cfg (the layout mirror)."""
    order = [layout for layout in frontend.FFT_LAYOUTS[1:] if layout[0] != "cluster"]
    first = order.index((frontend.BLOCK_LADDER[start[0]], start[1]))
    form = frontend.dft_form(cfg)
    for plan, groups in order[first:]:
        n = frontend._fft_smem(cfg, form, plan, True, groups)
        if n <= frontend.rs_kernel.SMEM_BUDGET_BYTES:
            return plan, groups, n, 233472 // (n + 1024)
    raise ValueError("no block plan fits")


def build(cu: pathlib.Path, csrc: pathlib.Path, so: pathlib.Path) -> pathlib.Path:
    """nvcc of one source with the kernels' flags, its headers from csrc: in
    the parts of kernels/_build.py PARTS where the source has them (an older
    checkout's front-end compiles whole)."""
    from mfcc_tpu_torch.kernels import _build

    parts = _build.PARTS["frontend"] if "FRONTEND_PARTS(" in cu.read_text() else 0
    try:
        _build.compile_source(cu, so, parts, csrc, name="frontend")
    except RuntimeError as e:
        raise SystemExit(f"nvcc failed on {cu}:\n{str(e)[-3000:]}")
    return so


class DroppedArguments:
    """A front-end library from before some of mfcc_frontend_logmel's last
    arguments, called through this checkout's wrapper: `drop` names them by
    their place from the end (2: `wide`, the one before the stream; 3:
    `cluster`, the one before it), and the call drops them (the wrapper
    passes 0 there whenever the parent's plan is taken, `in_turns`'
    layouts)."""

    def __init__(self, lib, drop: tuple[int, ...]):
        self._lib, self._drop = lib, drop

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "mfcc_frontend_logmel":
            return fn
        return lambda *args: fn(*(a for i, a in enumerate(args) if len(args) - i not in self._drop))


def bind(so: pathlib.Path, whole, names, drop: tuple[int, ...] = ()):
    """A build's library with the C signatures of the wrapper's own (an
    entry the build lacks left out); `drop`: a front-end from before some of
    mfcc_frontend_logmel's last arguments (`DroppedArguments`), wrapped."""
    lib = ctypes.CDLL(str(so))
    for name in names:
        if getattr(lib, name, None) is None:
            continue
        types = list(getattr(whole, name).argtypes)
        if name == "mfcc_frontend_logmel":
            types = [t for i, t in enumerate(types) if len(types) - i not in drop]
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = getattr(whole, name).restype
    return DroppedArguments(lib, drop) if drop else lib


def rows(pad_batch, cfg, n_rows: int, seed: int = 3, seconds: int = 10):
    """int16 rows of `seconds` (571 samples shorter each) at the rows' rate
    on the card."""
    import torch

    n = (cfg.input_sample_rate or cfg.sample_rate) * seconds
    g = np.random.default_rng(seed)
    utts = [(g.standard_normal(n - 571 * i) * 3000).astype(np.int16) for i in range(n_rows)]
    batch = pad_batch(utts, cfg, bucket_len=n, dtype="int16")
    return torch.as_tensor(batch.audio, device="cuda"), torch.as_tensor(batch.lengths, device="cuda")


def filter_field_meta(off, index, M: int):
    """The packed table of a front-end from before the filter field was
    dropped: bin | filter << 16 (every n_fft to 65,534 bins), the sign bit on
    each filter's last weight."""
    import torch

    meta = index // M | (index % M) << 16
    last = torch.zeros_like(meta, dtype=torch.bool)
    last[off[1:].long() - 1] = True
    return torch.where(last, meta - (1 << 31), meta).to(torch.int32)


def in_turns(torch, chip_smoke, module, libs: dict, fn, substr: str | None,
             packing: dict | None = None, layouts: dict | None = None) -> tuple[dict, dict]:
    """(ms per build of fn's kernels whose name holds substr, every kernel
    with None; one output per build) with each build bound as module's
    library, parent, change, change, parent; `packing` (the front-end's)
    names the packed table each build reads, bound with it; `layouts` the
    layout mirror each build's launch follows (the front-end's fft_layout:
    the parent's without the cluster plan)."""
    own, own_meta = module._lib, getattr(module, "packed_meta", None)
    own_layout = getattr(module, "fft_layout", None)
    ms = {key: [] for key in libs}
    outs = {}
    try:
        for key in ("parent", "change", "change", "parent"):
            module._lib = lambda key=key: libs[key]
            if packing:
                module.packed_meta = packing[key]
                module._device_tables.cache_clear()
            if layouts:
                module.fft_layout = layouts[key]
            outs[key] = fn()
            ms[key].append(chip_smoke.device_ms(torch, fn, substr))
    finally:
        module._lib = own
        if packing:
            module.packed_meta = own_meta
            module._device_tables.cache_clear()
        if layouts:
            module.fft_layout = own_layout
    return ms, outs


def without(layout, no_cluster: bool, no_wide: bool):
    """The layout mirror `layout` (frontend.fft_layout) without the cluster
    plan and the wide plan where the flags say so: the plan a parent from
    before them takes."""
    return lambda cfg, form=None, int16=True, cluster=True, wide=True: layout(
        cfg, form, int16, cluster and not no_cluster, wide and not no_wide)


def turns(parent: pathlib.Path, card: str, bf16x3_only: bool = False) -> int:
    """This checkout's front-end and tail against parent's, in turns (with
    bf16x3_only, the bf16x3 form's staged plan alone)."""
    import torch

    import chip_smoke
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import _build, frontend, tail
    from mfcc_tpu_torch.pipeline import pad_batch

    out = _build.BUILD_DIR / "turns"
    out.mkdir(parents=True, exist_ok=True)
    trees = {"change": _build.CSRC, "parent": parent.resolve() / "mfcc_tpu_torch" / "kernels" / "csrc"}
    jobs = [(key, src) for key in trees for src in (("frontend",) if bf16x3_only else ("frontend", "tail"))]
    src = (_build.CSRC / "frontend.cu").read_text()
    forced = () if bf16x3_only else FORCED
    for plan, start in forced:  # this checkout's source, the search started at the plan
        (out / f"forced_{plan}.cu").write_text(variant(src, start))
    cus = {**{j: trees[j[0]] / f"{j[1]}.cu" for j in jobs},
           **{(plan, "frontend"): out / f"forced_{plan}.cu" for plan, _ in forced}}
    def build_job(j):
        if j[0] == "change":  # this checkout's own build (kernels/_build.py, cached)
            return _build.build(j[1])[0]
        return build(cus[j], trees.get(j[0], _build.CSRC), out / f"{j[0]}_{j[1]}.so")

    with concurrent.futures.ThreadPoolExecutor(len(cus)) as pool:
        sos = dict(zip(cus, pool.map(build_job, cus)))
    parent_entry = (trees["parent"] / "frontend.cu").read_text()
    no_cluster = "int cluster," not in parent_entry
    no_wide = "int wide, void* stream" not in parent_entry
    drop = (3, 2) if no_cluster else (2,) if no_wide else ()
    fe = {key: bind(sos[key, "frontend"], frontend._lib(), FRONTEND_FNS, drop if key == "parent" else ())
          for key in trees}
    layouts = {"parent": without(frontend.fft_layout, no_cluster, no_wide), "change": frontend.fft_layout}
    print(f"in turns, parent {parent} [{card}]")

    def report(what, ms, outs):
        p, c = float(np.mean(ms["parent"])), float(np.mean(ms["change"]))
        print(f"{what}: parent {p:.4f} ms ({ms['parent'][0]:.4f}, {ms['parent'][1]:.4f}), change {c:.4f} ms "
              f"({ms['change'][0]:.4f}, {ms['change'][1]:.4f}), change / parent {c / p:.3f}; bitwise equal: "
              f"{bitwise(outs['change'], outs['parent'])}")

    parent_src = (trees["parent"] / "frontend.cu").read_text()
    block_parent = "kBfLadder" in parent_src
    # a parent whose packed table carries each weight's filter reads it so
    packing = {"parent": filter_field_meta if "meta_filter" in parent_src else frontend.packed_meta,
               "change": frontend.packed_meta}
    for name, over, n_rows, *secs in BF16X3_TURNS:
        seconds = secs[0] if secs else 10
        cfg = named_config(name).replace(**over)
        check(frontend.resample_route(cfg, "bf16x3") in (None, "fused"), f"{name} takes no split route")
        if frontend.bf16_layout(cfg)[0] != "staged" and not block_parent:
            continue  # the parent refuses the bf16x3 form past its staged plan
        audio, lengths = rows(pad_batch, cfg, n_rows, seconds=seconds)
        fn = lambda: frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")  # noqa: E731
        ms, outs = in_turns(torch, chip_smoke, frontend, fe, fn, "logmel_kernel", packing)
        errs = testing.prefix_errors(outs["change"], outs["parent"], cfg.n_mels, cfg.log_kind)
        if testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL):
            raise SystemExit(f"{name} {over} bf16x3: the builds disagree: {errs}")
        report(f"front-end bf16x3 {name} {over} b{n_rows} x {seconds} s, {frontend.bf16_layout(cfg, True)}",
               ms, outs)
        del audio, lengths, outs
    if bf16x3_only:
        return 0
    tl = {key: bind(sos[key, "tail"], tail._lib(), TAIL_FNS) for key in trees}
    for name, over, n_rows, *secs in TURNS:
        seconds = secs[0] if secs else 10
        cfg = named_config(name).replace(**over)
        audio, lengths = rows(pad_batch, cfg, n_rows, seconds=seconds)
        fn = lambda: frontend.logmel_prefix(audio, lengths, cfg)  # noqa: E731
        ms, outs = in_turns(torch, chip_smoke, frontend, fe, fn, "logmel_kernel", packing, layouts)
        errs = prefix_gates(testing, outs["change"], outs["parent"], cfg)
        if testing.prefix_failures(errs):
            raise SystemExit(f"{name} {over}: the builds disagree: {errs}")
        layout = frontend.fft_layout(cfg)
        report(f"front-end {name} {over} b{n_rows} x {seconds} s, {layout} (parent "
               f"{layouts['parent'](cfg)})", ms, outs)
        if layout[0] == "cluster":  # each cluster size that fits, in turns with the default
            print(f"  {frontend.kernel_info(cfg)}")
            form = frontend.dft_form(cfg)
            for C in frontend.CLUSTER_SIZES:
                if C == layout[1] or frontend.cluster_smem(cfg, form, C) > frontend.rs_kernel.SMEM_BUDGET_BYTES:
                    continue
                forced = {"parent": frontend.fft_layout, "change": lambda *a, C=C, **k: ("cluster", C)}
                ms, outs = in_turns(torch, chip_smoke, frontend, {"parent": fe["change"], "change": fe["change"]},
                                    fn, "logmel_kernel", None, forced)
                errs = testing.prefix_errors(outs["change"], outs["parent"], cfg.n_mels, cfg.log_kind)
                if testing.prefix_failures(errs):
                    raise SystemExit(f"{name} {over} at {C} blocks a cluster: {errs}")
                report(f"  forced to ('cluster', {C}) (change) against {layout} (parent)", ms, outs)
        del audio, lengths, outs
    for name, over, n_rows in TAIL_TURNS:
        cfg = named_config(name).replace(**over)
        audio, lengths = rows(pad_batch, cfg, n_rows)
        prefix, nv, _ = frontend.logmel_prefix_counts(audio, lengths, cfg)
        ms, outs = in_turns(torch, chip_smoke, tail, tl, lambda: tail.feature_tail(prefix, nv, cfg), None)
        errs = testing.tail_errors(outs["change"], outs["parent"])
        if testing.tail_failures(errs):
            raise SystemExit(f"{name} {over}: the builds disagree: {errs}")
        report(f"feature tail {name} {over} b{n_rows} x 10 s, plan {tail.plan(cfg)}", ms, outs)
        del audio, lengths, prefix, outs
    # this checkout forced to each new plan at one group, against its default
    # build ("gather_global" at one group) in turns
    name, over, n_rows = FORCED_AT
    cfg = named_config(name).replace(**over)
    check(frontend.fft_layout(cfg) == ("gather_global", 1), f"{name} {over} takes gather_global at one group")
    audio, lengths = rows(pad_batch, cfg, n_rows)
    own, own_layout = frontend._lib, frontend.fft_layout
    for plan, _ in FORCED:
        libs = {"parent": fe["change"], "change": bind(sos[plan, "frontend"], frontend._lib(), FRONTEND_FNS)}
        ms = {key: [] for key in libs}
        outs = {}
        try:
            for key in ("parent", "change", "change", "parent"):
                frontend._lib = lambda key=key: libs[key]
                # the mirror follows the build (the forced plan's workspace and counts)
                frontend.fft_layout = own_layout if key == "parent" else (lambda *a, plan=plan, **k: (plan, 1))
                fn = lambda: frontend.logmel_prefix(audio, lengths, cfg)  # noqa: E731
                outs[key] = fn()
                ms[key].append(chip_smoke.device_ms(torch, fn, "logmel_kernel"))
        finally:
            frontend._lib, frontend.fft_layout = own, own_layout
        errs = testing.prefix_errors(outs["change"], outs["parent"], cfg.n_mels, cfg.log_kind)
        if testing.prefix_failures(errs):
            raise SystemExit(f"{plan} forced at {name} {over}: the builds disagree: {errs}")
        report(f"front-end {name} {over} b{n_rows} x 10 s forced to {plan} (change) against "
               f"gather_global (parent), one group each", ms, outs)
    return 0


def wide_tiles(card: str) -> int:
    """This checkout's wide plan at each tile of WIDE_TILES that fits its
    layout, and at the launch's, in turns, at the wide cases of TURNS."""
    import torch

    import chip_smoke
    from mfcc_tpu_torch import named_config
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.pipeline import pad_batch

    print(f"the wide plan's tiles [{card}]")
    own_layout, own_tile = frontend.fft_layout, frontend.wide_tile
    for name, over, n_rows, *secs in TURNS:
        cfg = named_config(name).replace(**over)
        if frontend.fft_plan(cfg) != "wide":
            continue
        audio, lengths = rows(pad_batch, cfg, n_rows, seconds=secs[0] if secs else 10)
        fn = lambda: frontend.logmel_prefix(audio, lengths, cfg)  # noqa: E731
        want = fn()
        form = frontend.dft_form(cfg)
        groups, tile = frontend.wide_layout(cfg, form)
        fits = [t for t in WIDE_TILES if frontend.wide_groups(cfg, form, t) == groups]
        launch = own_tile(tile, n_rows * want.shape[1], frontend._wide_slots(cfg, True, want.device))
        ms = {t: [] for t in sorted({*fits, launch})}
        try:
            frontend.wide_tile = lambda tile, frames, slots: tile
            for order in (list(ms), list(ms)[::-1]):
                for t in order:
                    frontend.fft_layout = lambda *a, t=t, **k: ("wide", t)
                    check(bitwise(fn(), want), f"{name} {over} at a tile of {t}: bitwise the launch's")
                    ms[t].append(chip_smoke.device_ms(torch, fn, "logmel_kernel"))
        finally:
            frontend.fft_layout, frontend.wide_tile = own_layout, own_tile
        print(f"{name} {over} b{n_rows}: layout ('wide', {tile}), {groups} groups, launch tile {launch}: " + ", ".join(
            f"{t} {float(np.mean(v)):.4f} ms ({v[0]:.4f}, {v[1]:.4f})" for t, v in ms.items()))
        del audio, lengths, want
    return 0


def wide_rule(card: str) -> int:
    """This checkout's wide plan forced against the ladder's plan without it,
    in turns, at RULE_TURNS."""
    import torch

    import chip_smoke
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.pipeline import pad_batch

    print(f"the wide plan's size rule (WIDE_MIN_FILTERS {frontend.WIDE_MIN_FILTERS}) [{card}]")
    own = frontend.fft_layout
    lib = frontend._lib()
    ladder = lambda cfg, form=None, int16=True, cluster=True, wide=True: own(cfg, form, int16, cluster, False)  # noqa: E731
    for name, over, n_rows in RULE_TURNS:
        cfg = named_config(name).replace(**over)
        parent = ladder(cfg)
        shape = frontend.wide_layout(cfg)
        check(parent[0] in ("gather_bands", "gather_rows") and shape is not None,
              f"{name} {over}: the ladder gives {parent}, the wide plan {shape}")
        forced = lambda *a, tile=shape[1], **k: ("wide", tile)  # noqa: E731
        audio, lengths = rows(pad_batch, cfg, n_rows)
        fn = lambda: frontend.logmel_prefix(audio, lengths, cfg)  # noqa: E731
        ms, outs = in_turns(torch, chip_smoke, frontend, {"parent": lib, "change": lib}, fn, "logmel_kernel",
                            None, {"parent": ladder, "change": forced})
        errs = prefix_gates(testing, outs["change"], outs["parent"], cfg)
        if testing.prefix_failures(errs):
            raise SystemExit(f"{name} {over}: the wide plan and {parent} disagree: {errs}")
        p, c = float(np.mean(ms["parent"])), float(np.mean(ms["change"]))
        M = cfg.n_mels
        print(f"{name} {over} b{n_rows} x 10 s, the ladder's {parent} (taken: {own(cfg)}): "
              f"{parent[0]} {p:.4f} ms ({ms['parent'][0]:.4f}, {ms['parent'][1]:.4f}), wide (tile {shape[1]}, "
              f"{shape[0]} groups) {c:.4f} ms ({ms['change'][0]:.4f}, {ms['change'][1]:.4f}), wide / "
              f"{parent[0]} {c / p:.3f}; lanes [0, {M}) bitwise equal: "
              f"{bitwise(outs['change'][..., :M], outs['parent'][..., :M])}; {frontend.packed_count(cfg):,} "
              f"weights for {M:,} filters")
        del audio, lengths, outs
    return 0


def bitwise(a, b) -> bool:
    """a and b equal bit for bit (NaN-safe: an SSC filter with no weight is
    0/0 in every build)."""
    import torch

    return a.shape == b.shape and bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def prefix_gates(testing, got, want, cfg) -> dict:
    """`testing.prefix_errors` of two builds' prefixes, NaN lanes (in the same
    places, else a failure) left out."""
    import torch

    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"{cfg.features}: NaN in the same lanes in both builds")
    return testing.prefix_errors(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0), cfg.n_mels, cfg.log_kind,
                                 cfg.features)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"block_plan_sweep: {what}")


def main() -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--parent", type=pathlib.Path, help="root of another checkout: time both in turns")
    args.add_argument("--bf16x3", action="store_true", help="with --parent: the bf16x3 form's turns alone")
    args.add_argument("--wide-tiles", action="store_true", help="the wide plan's tiles in turns")
    args.add_argument("--wide-rule", action="store_true", help="the wide plan against the ladder without it")
    args = args.parse_args()
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
    if args.parent is not None:
        return turns(args.parent, card, args.bf16x3)
    if args.wide_tiles:
        return wide_tiles(card)
    if args.wide_rule:
        return wide_rule(card)
    src = (_build.CSRC / "frontend.cu").read_text()
    out = _build.BUILD_DIR / "block_plan_sweep"
    out.mkdir(parents=True, exist_ok=True)

    def build_start(start):
        cu = out / f"start{start[0]}{start[1]}.cu"
        cu.write_text(variant(src, start))
        return build(cu, _build.CSRC, cu.with_suffix(".so"))

    with concurrent.futures.ThreadPoolExecutor(len(STARTS)) as pool:
        sos = dict(zip(STARTS, pool.map(build_start, STARTS)))
    whole = frontend._lib()
    libs = {start: bind(so, whole, FRONTEND_FNS) for start, so in sos.items()}
    print(f"block plan sweep [{card}]")
    own = frontend._lib
    for name, n_fft, n_rows in PATHS:
        cfg = (named_config("logmel80").replace(**LIBROSA) if name == "librosa"
               else named_config(name).replace(n_fft=n_fft))
        audio, lengths = rows(pad_batch, cfg, n_rows)
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
        framed = st["windowed"].reshape(n_rows * st["windowed"].shape[1], -1).contiguous()
        del st
        rfft_ms = chip_smoke.device_ms(torch, lambda: torch.fft.rfft(framed, n=cfg.n_fft, dim=-1))
        print(f"{name} n_fft {n_fft} b{n_rows} x 10 s: rfft(n={n_fft}) {rfft_ms:.4f} ms of device time; "
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
