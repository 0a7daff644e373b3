#!/usr/bin/env python3
"""Where the front-end kernel's time goes, on one CUDA card.

    python3 scripts/frontend_breakdown.py [--root DIR]

Builds the front-end kernel of the checkout at DIR (default: this one;
any checkout of `mfcc_tpu_torch` with csrc/frontend.cu, e.g. an older
commit unpacked by `git archive`) three times from its own source: whole
(P0), cut after staging (P1: each frame writes a few staged samples), and
cut before the projection (P2: each frame writes its first power bins, so
staging, the DFT and the split still run). Times each with the profiler's
device time of the kernel, L2 flushed before every launch, in turns
(P1, P2, P0, P0, P2, P1), at classic13_deltas b64 x 10 s, logmel80 b256 x
10 s, whisper80 b64 x 30 s, mfcc39_48k b64 x 10 s (the fused resample's
int16 instantiation: there P1 is the staging with the FIR) and kaldi_mfcc
with dither 1.0 b64 x 10 s (the dither and conditioning instantiation:
there P1 is the staging with the dither) int16, and at
classic13 b64 x 10 s through
the bf16x3 form (there P2 - P1 is the tensor-core product and its |X|^2
stores), and prints the registers (ptxas) and
the blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
int16 plain instantiation, and the opcode counts of that instantiation's
SASS and of the bf16x3 one's (cuobjdump, static counts), beside the card's
name and power limit. The differences P1, P2 - P1 and P0 - P2 are staging,
DFT and split, and the projection with its epilogue. Imports nothing of
JAX.

With --large it times phase 29's two cases whose plans the cluster plan
redesigned (`LARGE`: librosa's 16,384-point framing at 44.1 kHz, b64 x 30
s, and classic13_deltas at n_fft 32,768, b16 x 10 s) in the plan the
checkout's layout mirror takes: there P1 cuts after each frame's staging
(the gather plans' frame written into a row from device memory, step 2g;
the cluster plan's loads of its ranks' samples) and P2 after the powers
(the cluster plan: every rank's stored). An older checkout at DIR (its
source compiled whole) gives the parent's breakdown. The cuts build with
this checkout's kernels/_build.py (in parts where the source has them).

With --wide it times the wide plan's cases (`WIDE`: classic13_deltas at
60,000 and 40,000 filters b16 x 10 s, ssc26 at 30,000 filters and n_fft
4,096 b16 x 10 s) the same way: P1 cuts its FFT stage after each frame's
staging (step 2g) and P2 before its projection (stage 2), both leaving
stage 2 out, so P1 is the staging, P2 - P1 the FFT stage's DFT and powers,
P0 - P2 the projection filter by filter with its stores.

With --bf16 it times the bf16x3 form's block plans (`BF16_CASES`:
classic13_deltas at n_fft 4,096 b64 x 10 s, librosa's
melspectrogram(n_fft=8192) framing b16 x 30 s, classic13_deltas with
40,000 filters b16 x 10 s) whole and with one piece taken out at a time
(`BF16_CUTS`, anchored in the source of either the checkout or an older
one): the A operand's build, the wait for the ring's matrix chunks, the
tensor-core products, |X|^2 with the projection, and the epilogue. Whole
less a cut is that piece's exposed time (the pieces overlap, so they do
not add up to the whole). Only the int16 block-plan instantiations differ
between cuts: the other parts of the source are compiled once and linked
into every cut's library.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

STAGED = "  __syncthreads();\n\n  const int warp = threadIdx.x >> 5;"
CUT_STAGED = """  __syncthreads();
#if CUT == 1
  if (!(kBlock && p.gather)) {  // the gather plans stage each frame in its loop (GATHER_STAGED)
  if constexpr (kBf16) {  // the ring's first copies land before the block leaves
    if (dft && threadIdx.x == kProducer) {
      for (int c = 0; c < imin(p.stages, p.npass * (p.kp / kBfStep)); ++c) mbar_wait(full + c, 0);
    }
  }
  for (int fl = threadIdx.x >> 5; fl < kTile && f0 + fl < F; fl += kWarps) {
    const int ln = threadIdx.x & 31;
    if (ln <= M) out[(static_cast<size_t>(b) * F + f0 + fl) * (M + 1) + ln] = sig[fl * S + ln];
  }
  return;
  }
#endif

  const int warp = threadIdx.x >> 5;"""
# the FFT form's call of the projection, in every version of the source
PROJECTION = re.compile(
    r"    write_frame(?:<kCond>)?\(out \+ \(static_cast<size_t>\(b\) \* F \+ f\) \* \(M \+ 1\), pw,"
    r"[^;]*;")
CUT_PROJECTION = """#if CUT == 2
    if (lane <= M) out[(static_cast<size_t>(b) * F + f) * (M + 1) + lane] = pw[lane];
#else
{call}
#endif"""
# the gather plans' staging of a frame (step 2g, csrc/frontend.cu
# group_frame, which the block plans' group loop and the wide plan's stage 1
# call), and the cluster plan's: P1 cuts after it (group_frame returns the
# staged frame as pw; the block plans' loop writes a few samples of it and
# goes on to the next frame, GATHER_FRAME)
GATHER_STAGED = """    team.sync();
    fr = g;
  }"""
CUT_GATHER_STAGED = """    team.sync();
    fr = g;
#if CUT == 1
    pw = g;
    es = 0.f;
    return;
#endif
  }"""
GATHER_FRAME = """                                      bs, red, pw, es, e_frame);
"""
CUT_GATHER_FRAME = GATHER_FRAME + """#if CUT == 1
          if (gather) {
            if (rank <= M) out[(static_cast<size_t>(b) * F + f) * (M + 1) + rank] = pw[rank];
            team.sync();
            continue;
          }
#endif
"""
# an older source's (before group_frame): the block plans' loop stages the
# frame itself
OLD_GATHER_STAGED = """              team.sync();
              fr = g;
            }"""
CUT_OLD_GATHER_STAGED = """              team.sync();
              fr = g;
#if CUT == 1
              if (rank <= M) out[(static_cast<size_t>(b) * F + f) * (M + 1) + rank] = g[rank];
              team.sync();
              continue;
#endif
            }"""
GATHER_CUTS = (((GATHER_STAGED, CUT_GATHER_STAGED), (GATHER_FRAME, CUT_GATHER_FRAME)),
               ((OLD_GATHER_STAGED, CUT_OLD_GATHER_STAGED),))
CLUSTER_STAGED = """      float* pw;
      if (p.form == kBluestein) {"""
CUT_CLUSTER_STAGED = """#if CUT == 1
      {
        float acc = 0.f;
        for (int n = tid; n < n2; n += kThreads) {
          const int a = 2 * (C * n + rank);
          acc += (a < Lk ? sample(a) : 0.f) + (a + 1 < Lk ? sample(a + 1) : 0.f);
        }
        part[tid] = acc;
        if (rank == 0 && tid <= M) out[(static_cast<size_t>(b) * F + f) * (M + 1) + tid] = acc;
        cl.sync();
        continue;
      }
#endif
""" + CLUSTER_STAGED
# the cluster plan's powers, every rank's stored: P2 cuts there
CLUSTER_POWERS = """    float* o = out + (static_cast<size_t>(b) * F + f) * (M + 1);
    const float* pw = reinterpret_cast<const float*>(rank_row(pwi));"""
CUT_CLUSTER_POWERS = CLUSTER_POWERS + """
#if CUT == 2
    if (tid <= M && tid < bhi - blo) o[tid] = pw[tid];
    cl.sync();
    continue;
#endif"""
# the wide plan's frame after group_frame (under P1 its staged frame), and
# its projection (stage 2): P1 cuts after the first, P1 and P2 leave out the
# second
WIDE_STAGED = """                                  twiddle, bases, red, pw, es, e_frame);
"""
CUT_WIDE_STAGED = WIDE_STAGED + """#if CUT == 1
      if (rank == 0) en[fl] = pw[0];
      team.sync();
      continue;
#endif
"""
WIDE_PROJECTION = """  auto project = [&](auto finish) {
"""
CUT_WIDE_PROJECTION = WIDE_PROJECTION + """#if CUT != 0
    if (M > 0) return;
#endif
"""
OCCUPANCY = """
#if !defined(FRONTEND_PART) || FRONTEND_PART == 1
#ifdef FRONTEND_PART
using namespace mfcc_frontend;
#endif
extern "C" int frontend_breakdown_blocks(int smem) {
  auto k = logmel_kernel<int16_t, false, false, false, false>;
  int n = -1;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, 256, smem) != cudaSuccess) return -1;
  return n;
}
#endif
"""
PATHS = (("classic13_deltas", 64, 10, "radix4", {}), ("logmel80", 256, 10, "radix4", {}),
         ("whisper80", 64, 30, "radix4", {}), ("mfcc39_48k", 64, 10, "radix4", {}),
         ("kaldi_mfcc", 64, 10, "radix4", {"dither": 1.0}), ("classic13", 64, 10, "bf16x3", {}))
# the int16 instantiations' mangled names (a sixth template argument, the
# block plan's, since the block FFT plan; its false keeps these)
PLAIN = r"logmel_kernelIsLb0ELb0ELb0ELb0E(?:Lb0E)?EE"
BF16X3 = r"logmel_kernelIsLb0ELb0ELb0ELb1E(?:Lb0E)?EE"


def variants(src: str) -> dict[int, str]:
    """The source with both cut points, once per CUT value: after the tile's
    staging and before the projection in the warp and block plans, after
    each frame's staging in the gather plans, and (where the source has it)
    after the cluster plan's frame loads and its powers."""
    assert src.count(STAGED) == 1, "staging anchor not found"
    src, n = PROJECTION.subn(lambda m: CUT_PROJECTION.format(call=m.group(0)), src)
    assert n >= 1, "projection anchor not found"
    src = src.replace(STAGED, CUT_STAGED)
    pairs = next((pairs for pairs in GATHER_CUTS if all(src.count(a) == 1 for a, _ in pairs)), None)
    assert pairs is not None, "the gather plans' staging anchors not found"
    for anchor, cut in pairs:
        src = src.replace(anchor, cut)
    if "logmel_kernel_cluster" in src:
        assert src.count(CLUSTER_STAGED) == 1 and src.count(CLUSTER_POWERS) == 1, "cluster anchors not found"
        src = src.replace(CLUSTER_STAGED, CUT_CLUSTER_STAGED).replace(CLUSTER_POWERS, CUT_CLUSTER_POWERS)
    if "logmel_kernel_wide" in src:
        assert src.count(WIDE_STAGED) == 1 and src.count(WIDE_PROJECTION) == 1, "wide plan anchors not found"
        src = src.replace(WIDE_STAGED, CUT_WIDE_STAGED).replace(WIDE_PROJECTION, CUT_WIDE_PROJECTION)
    return {cut: f"#define CUT {cut}\n" + src + OCCUPANCY for cut in (0, 1, 2)}


def build(csrc: pathlib.Path, out: pathlib.Path, cut: int, text: str):
    """One cut's library, in the parts its source has (kernels/_build.py
    PARTS; an older checkout's source compiles whole); (path, registers of
    the int16 plain instantiation)."""
    _build = own_build()
    cu = out.with_suffix(".cu")
    cu.write_text(text)
    parts = _build.PARTS["frontend"] if "FRONTEND_PARTS(" in text else 0
    try:
        log = _build.compile_source(cu, out, parts, csrc, name="frontend")
    except RuntimeError as e:
        raise SystemExit(f"nvcc failed on cut {cut}:\n{e}")
    regs = re.search(PLAIN + r".*?Used (\d+) registers", log, re.S)
    return out, int(regs.group(1)) if regs else -1


def own_build():
    """This checkout's kernels/_build.py (its parts and its nvcc), whatever
    checkout --root names."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "mfcc_tpu_torch" / "kernels" / "_build.py"
    mod = sys.modules.get("mfcc_tpu_torch.kernels._build")
    if mod is not None and pathlib.Path(mod.__file__).resolve() == path:
        return mod  # the one already imported: one cap on the nvcc processes of a run
    spec = importlib.util.spec_from_file_location("frontend_breakdown_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_opcodes(so: pathlib.Path, nvcc: str, kernel: str = PLAIN) -> dict[str, int]:
    """Static SASS opcode counts of one instantiation in `so` (its mangled
    name matches the pattern `kernel`), by cuobjdump; empty when it is not
    there."""
    tool = pathlib.Path(nvcc).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", dump):
        if re.search(kernel, fn.split("\n", 1)[0]):
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", fn)
            return {o: ops.count(o) for o in set(ops)}
    return {}


def sass_counts(so: pathlib.Path, nvcc: str, kernel: str = PLAIN) -> str:
    """The total and the 12 commonest opcodes of `sass_opcodes`."""
    ops = sass_opcodes(so, nvcc, kernel)
    if not ops:
        return "not found"
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
    return f"{sum(ops.values())} instructions: " + ", ".join(f"{o} {n}" for o, n in top)


def device_ms(torch, fn, sessions: int = 3, tries: int = 8) -> float:
    """Median over `sessions` profiler sessions of the kernel's mean device
    time in five launches, L2 flushed before each; a session that lost
    records is taken again, up to `tries` sessions in all. Without a whole
    session, CUDA events around the five launches (flush included) stand in."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        ev = [e.self_device_time_total for e in prof.events()
              if e.device_type.name == "CUDA" and "logmel_kernel" in e.name]
        if len(ev) == 5:
            times.append(np.mean(ev) / 1e3)
            if len(times) == sessions:
                break
    if times:
        return float(np.median(times))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        flush.zero_()
        fn()
    end.record()
    torch.cuda.synchronize()
    print("  (the profiler lost records in every session: CUDA events, the flushes included)")
    return start.elapsed_time(end) / 5


def build_cuts(csrc: pathlib.Path, out: pathlib.Path) -> dict:
    """The three cuts of csrc/frontend.cu, built in parallel into the
    directory `out`: (path, registers of the int16 plain instantiation) by
    cut."""
    from mfcc_tpu_torch.kernels import _build

    texts = variants((csrc / "frontend.cu").read_text())
    out.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        return dict(zip(texts, pool.map(lambda c: build(csrc, out / f"cut{c}.so", c, texts[c]), texts)))


def bind_cuts(built: dict, whole) -> dict:
    """The built cuts loaded and bound as the checkout's own library `whole`
    is, by cut."""
    libs = {}
    for cut, (path, _) in built.items():
        lib = ctypes.CDLL(str(path))
        for name in ("mfcc_frontend_logmel", "mfcc_frontend_logmel_resample", "mfcc_frontend_error_string",
                     "mfcc_frontend_kernel_info", "mfcc_frontend_cluster_info", "mfcc_frontend_wide_info"):
            if getattr(whole, name, None) is None:
                continue  # an older checkout's entry that it has not
            getattr(lib, name).argtypes = getattr(whole, name).argtypes
            getattr(lib, name).restype = getattr(whole, name).restype
        lib.frontend_breakdown_blocks.argtypes = [ctypes.c_int]
        libs[cut] = lib
    return libs


def time_cuts(torch, frontend, libs, cfg, audio, lengths, dft_passes: str = "radix4",
              timer=None) -> dict:
    """Device ms of the kernel with each cut's library in place of the
    checkout's own, in turns (P1, P2, P0, P0, P2, P1), by `timer` (default
    `device_ms`; a caller that has its own profiler sessions passes its
    own); the wrapper's own library is put back after."""
    timer = timer or (lambda fn: device_ms(torch, fn))
    own = frontend._lib
    ms = {0: [], 1: [], 2: []}
    try:
        for cut in (1, 2, 0, 0, 2, 1):
            frontend._lib = lambda cut=cut: libs[cut]
            ms[cut].append(timer(lambda: frontend.logmel_prefix(
                audio, lengths, cfg, dft_passes=dft_passes)))
    finally:
        frontend._lib = own
    return ms


# --large: phase 29's cases (chip_smoke.py ANY_NFFT) whose plans the cluster
# plan redesigned: librosa's melspectrogram(sr=44100, n_fft=16384,
# hop_length=4096, n_mels=128) at b64 x 30 s ("gather_bands" before it) and
# classic13_deltas at n_fft 32,768, b16 x 10 s ("gather_rows" before it)
LIBROSA_16384 = dict(sample_rate=44100, n_fft=16384, win_len_s=16384 / 44100, hop_s=4096 / 44100, n_mels=128,
                     mel_variant="librosa_hz", mel_scale="slaney", mel_norm="slaney", mel_low_hz=0.0,
                     mel_high_hz=22050.0)
LARGE = (("logmel80", 64, 30, "radix4", LIBROSA_16384), ("classic13_deltas", 16, 10, "radix4", {"n_fft": 32768}))
# --wide: the wide plan's cases (chip_smoke.py MANY_FILTERS)
WIDE = (("classic13_deltas", 16, 10, "radix4", {"n_mels": 60000}),
        ("ssc26", 16, 10, "radix4", {"n_mels": 30000, "n_fft": 4096}),
        ("classic13_deltas", 16, 10, "radix4", {"n_mels": 40000}))


# --bf16: the bf16x3 block plans' cases (chip_smoke.py BF16X3_PLANS and
# MANY_FILTERS): "pass" at n_fft 4,096, "gather" at librosa's 8,192-point
# framing (L = n_fft), "gather_out" at 40,000 filters
LIBROSA_8192 = dict(sample_rate=22050, n_fft=8192, win_len_s=8192 / 22050, hop_s=2048 / 22050, n_mels=128)
BF16_CASES = (("classic13_deltas", 64, 10, "bf16x3", {"n_fft": 4096}),
              ("logmel80", 16, 30, "bf16x3", LIBROSA_8192),
              ("classic13_deltas", 16, 10, "bf16x3", {"n_mels": 40000}))
# the pieces each cut takes out of the block plans, as (anchor, replacement)
# pairs of the source: the parent's design ("register A": the A fragment
# built from the frame in registers each step of each pass)
BF16_CUTS = {
    "register A": {
        "A build": [("            fragment(imin(s + 1, steps - 1) * kBfStep, nh, nl);",
                     "            for (int q = 0; q < 4; ++q) { nh[q] = ah[q]; nl[q] = al[q]; }")],
        "ring wait": [("              mbar_wait(full + slot, (c / p.stages) & 1);",
                       "              if (c < p.stages) mbar_wait(full + slot, (c / p.stages) & 1);"),
                      ("    } else if (threadIdx.x == kProducer && (dft || !kBlock)) {",
                       "    } else if (threadIdx.x == kProducer && (dft && !kBlock)) {")],
        "products": [("              products(slot, ah, al);", "              (void)ah;")],
        "projection": [("          project(pass);", "          (void)pass;")],
        "epilogue": [("      for (int i = threadIdx.x; i < tile * (M + 1); i += kThreads) {",
                      "      for (int i = threadIdx.x; i < 0; i += kThreads) {")],
    },
    # the redesign ("A once a tile"): A built once a tile into shared memory
    # or the workspace, two consumer warpgroups, the projection on warps of
    # its own
    "A once a tile": {
        "A build": [("    for (int u = tid; u < steps * 2 * tile; u += kBfThreads) {",
                     "    for (int u = tid; u < 0; u += kBfThreads) {")],
        "ring wait": [("        if (dft) {\n          mbar_wait(full + slot, (c / p.stages) & 1);",
                       "        if (dft) {\n          if (c < p.stages) mbar_wait(full + slot, (c / p.stages) & 1);"),
                      ("        for (int c = p.stages; c < chunks; ++c) {",
                       "        for (int c = chunks; c < chunks; ++c) {")],
        "products": [("          fence_regs(re1);\n          wgmma_m64n136k16_ss(re0, ah, wh);",
                      "          fence_regs(re1);\n          if (false) {\n          wgmma_m64n136k16_ss(re0, ah, wh);"),
                     ("          wgmma_m64n136k16_ss(re1, ah, wl + second);\n",
                      "          wgmma_m64n136k16_ss(re1, ah, wl + second);\n          }\n")],
        "projection": [("  auto project = [&](int pass) {\n",
                        "  auto project = [&](int pass) {\n    if (pass >= 0) return;\n")],
        "epilogue": [("    for (int fl = ti; fl < tile && f0 + fl < F; fl += kBfTeam) {",
                      "    for (int fl = ti; fl < 0; fl += kBfTeam) {")],
    },
}
# the source's part (FRONTEND_PART) of the int16 block-plan instantiations
BF16_BLOCK_PART = 7


def bf16_variants(src: str) -> dict[str, str]:
    """The source whole and with each cut of the design whose anchors it
    holds (each anchor once)."""
    for design, cuts in BF16_CUTS.items():
        if all(src.count(a) == 1 for pairs in cuts.values() for a, _ in pairs):
            out = {"whole": src}
            for name, pairs in cuts.items():
                text = src
                for a, r in pairs:
                    text = text.replace(a, r)
                out[name] = text
            return design, out
    raise SystemExit("no bf16x3 block-plan design's anchors found in the source")


def build_bf16_cuts(csrc: pathlib.Path, out: pathlib.Path):
    """Every cut of `bf16_variants` into the directory `out`: the source's
    parts compiled once, the int16 block-plan part once a cut, each cut's
    library linked from them; (design, {cut: library path}, compiler log of
    the whole's block-plan part)."""
    _build = own_build()
    design, texts = bf16_variants((csrc / "frontend.cu").read_text())
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    nparts = _build.PARTS["frontend"]
    jobs = [(name, k) for k in range(nparts) for name in ("whole",) if k != BF16_BLOCK_PART]
    jobs += [(name, BF16_BLOCK_PART) for name in texts]
    for name, text in texts.items():
        (out / f"{_slug(name)}.cu").write_text(text)

    def compile_part(job):
        name, k = job
        obj = out / f"{_slug(name)}.part{k}.o"
        log = _build._run([*flags, "-c", f"-DFRONTEND_PART={k}", "-I", str(csrc), "-o", str(obj),
                           str(out / f"{_slug(name)}.cu")], f"{name} part {k}")
        return obj, log

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(compile_part, jobs)))
    libs = {}
    for name in texts:
        objs = [done[("whole", k) if k != BF16_BLOCK_PART else (name, k)][0] for k in range(nparts)]
        lib = out / f"{_slug(name)}.so"
        _build._run([*_build.NVCC_FLAGS, "-o", str(lib), *map(str, objs)], f"the link of {name}")
        libs[name] = lib
    return design, libs, done[("whole", BF16_BLOCK_PART)][1]


def _slug(name: str) -> str:
    return name.replace(" ", "_")


def bf16_main(root: pathlib.Path, torch, frontend, _build, named_config, pad_batch, card: str) -> int:
    """--bf16: each of BF16_CASES whole and with each cut taken out, in
    turns (the cuts, then whole, then whole and the cuts again), device
    time of the kernel, L2 flushed before each launch."""
    csrc = root / "mfcc_tpu_torch" / "kernels" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        design, paths, log = build_bf16_cuts(csrc, pathlib.Path(tmp))
        print(f"{root}: the {design} design, built {len(paths)} cuts in {time.perf_counter() - t0:.1f} s")
        for line in re.findall(r"Compiling entry function '(\S*logmel_kernel\S*)'.*?\n(.*?registers.*?)\n",
                               log, re.S):
            print(f"  ptxas {line[0][:60]}: {' '.join(line[1].split())}")
        load = _build.load
        _build.load = lambda name: ctypes.CDLL(str(paths["whole"])) if name == "frontend" else load(name)
        frontend._lib.cache_clear()
        whole = frontend._lib()
        libs = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for fn in ("mfcc_frontend_logmel", "mfcc_frontend_error_string", "mfcc_frontend_kernel_info"):
                getattr(lib, fn).argtypes = getattr(whole, fn).argtypes
                getattr(lib, fn).restype = getattr(whole, fn).restype
            libs[name] = lib
        for name, B, secs, passes, over in BF16_CASES:
            cfg = named_config(name).replace(**over)
            n = cfg.sample_rate * secs
            g = np.random.default_rng(0)
            utts = [(g.standard_normal(n - 571 * i) * 3000).astype(np.int16) for i in range(B)]
            batch = pad_batch(utts, cfg, bucket_len=n, dtype="int16")
            audio = torch.as_tensor(batch.audio, device="cuda")
            lengths = torch.as_tensor(batch.lengths, device="cuda")
            order = [c for c in libs if c != "whole"] + ["whole"]
            ms = {c: [] for c in libs}
            own = frontend._lib
            try:
                for cut in order + order[::-1]:
                    frontend._lib = lambda cut=cut: libs[cut]
                    ms[cut].append(device_ms(torch, lambda: frontend.logmel_prefix(
                        audio, lengths, cfg, dft_passes=passes)))
            finally:
                frontend._lib = own
            info = frontend.kernel_info(cfg, True, passes)
            w = float(np.mean(ms["whole"]))
            parts = ", ".join(f"{c} {w - float(np.mean(ms[c])):.4f}" for c in libs if c != "whole")
            print(f"  {name}{''.join(f' {k} {v}' for k, v in over.items())} b{B} x {secs} s, "
                  f"{frontend.bf16_layout(cfg, True)}: whole {w:.4f} ms (runs {ms['whole'][0]:.4f}, "
                  f"{ms['whole'][1]:.4f}); exposed: {parts}; without each: "
                  f"{', '.join(f'{c} {float(np.mean(ms[c])):.4f}' for c in libs if c != 'whole')}; "
                  f"{frontend.smem_bytes(cfg, passes, True)} B a block, {info} [{card}]")
            del audio, lengths
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--large", action="store_true", help="phase 29's two cases (LARGE) alone")
    ap.add_argument("--wide", action="store_true", help="the wide plan's cases (WIDE) alone")
    ap.add_argument("--bf16", action="store_true", help="the bf16x3 block plans' cuts (BF16_CASES) alone")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("frontend_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from mfcc_tpu_torch import named_config
    from mfcc_tpu_torch.kernels import _build, frontend
    from mfcc_tpu_torch.pipeline import pad_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if args.bf16:
        return bf16_main(root, torch, frontend, _build, named_config, pad_batch, card)
    csrc = root / "mfcc_tpu_torch" / "kernels" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        built = build_cuts(csrc, pathlib.Path(tmp))
        print(f"{root}: built the three cuts in {time.perf_counter() - t0:.1f} s")
        # the checkout's wrapper bound to cut 0 (the whole kernel), not to a
        # build of its own
        load = _build.load
        _build.load = lambda name: ctypes.CDLL(str(built[0][0])) if name == "frontend" else load(name)
        frontend._lib.cache_clear()
        libs = bind_cuts(built, frontend._lib())
        print(f"{root}: registers (int16 plain instantiation) P0 {built[0][1]}, P1 {built[1][1]}, "
              f"P2 {built[2][1]} [{card}]")
        if not (args.large or args.wide):
            print(f"  SASS of P0's int16 plain instantiation: {sass_counts(built[0][0], _build.nvcc())}")
            print(f"  SASS of P0's int16 bf16x3 instantiation: "
                  f"{sass_counts(built[0][0], _build.nvcc(), BF16X3)}")
        for name, B, secs, passes, over in WIDE if args.wide else LARGE if args.large else PATHS:
            cfg = named_config(name).replace(**over)
            n = (cfg.input_sample_rate or cfg.sample_rate) * secs
            step = 1713 if cfg.input_sample_rate else 571  # chip_smoke.py's rows
            g = np.random.default_rng(0)
            if name == "whisper80":
                pcm = (g.standard_normal((B, n)) * 3000).astype(np.int16)
                audio = torch.as_tensor(pcm, device="cuda")
                lengths = torch.full((B,), n, dtype=torch.int32, device="cuda")
            else:
                utts = [(g.standard_normal(n - step * i) * 3000).astype(np.int16) for i in range(B)]
                batch = pad_batch(utts, cfg, bucket_len=n, dtype="int16")
                audio = torch.as_tensor(batch.audio, device="cuda")
                lengths = torch.as_tensor(batch.lengths, device="cuda")
            smem = frontend.smem_bytes(cfg, passes)
            ms = time_cuts(torch, frontend, libs, cfg, audio, lengths, passes)
            p0, p1, p2 = (float(np.mean(ms[c])) for c in (0, 1, 2))
            layout = frontend.fft_layout(cfg) if passes != "bf16x3" else ("bf16x3", 0)
            # not the plain instantiation
            own = passes == "bf16x3" or cfg.input_sample_rate or cfg.dither > 0.0 or layout[0] != "warp"
            info = frontend.kernel_info(cfg, True, passes) if own else None
            blocks = info["blocks_per_sm"] if own else libs[0].frontend_breakdown_blocks(smem)
            dft = "tensor-core product" if passes == "bf16x3" else "DFT and split"
            stage = ("staging with the FIR" if cfg.input_sample_rate
                     else "staging with the dither" if cfg.dither > 0.0 else "staging")
            print(f"  {name}{''.join(f' {k} {v}' for k, v in over.items())} {passes} b{B} x {secs} s, {layout}: "
                  f"P1 {stage} {p1:.4f} ms, P2 +{dft} {p2:.4f}, "
                  f"P0 whole {p0:.4f} (runs {ms[0][0]:.4f}, {ms[0][1]:.4f}); {stage} {p1:.4f}, "
                  f"{dft} {p2 - p1:.4f}, projection {p0 - p2:.4f}; {smem} B a block, "
                  f"{blocks} blocks an SM{f', {info}' if info and layout[0] != 'warp' else ''} [{card}]")
            del audio, lengths
    return 0


if __name__ == "__main__":
    sys.exit(main())
