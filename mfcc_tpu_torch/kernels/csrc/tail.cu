// The cepstral feature tail for Hopper (sm_90a): [log-mel | energy] prefix
// -> finished MFCC features [ceps | delta | delta-delta], masked, with
// utterance CMVN when configured.
//
// Replaces mfcc_tpu/kernels/frontend.py::_make_feature_tail (:714-804), the
// in-kernel epilogue that the reference reaches through
// fused_logmel_stages(feature_tail=True) (:1724, :1799-1803, :1841-1844).
// Plain version and wrapper: mfcc_tpu_torch/kernels/tail.py
// (feature_tail_reference, feature_tail), which is the prefix branch of
// mfcc_tpu_torch/ops/chain.py features_from_logmel for mfcc configs.
//
// Per utterance b (nv = n_valid[b], last = max(nv - 1, 0)) and frame s < F,
// with M1 = n_mels + 1 prefix lanes, C = n_ceps, N = delta_window:
//   x[s, M]  = max(ln(where(e <= 0, eps, e)), ln(energy_floor)) when
//              append_energy (e = prefix lane M; the floor only when
//              energy_floor > 0); the other lanes as they are
//   base[s]  = x[s] . dct_aug            ([M1, C]: DCT * lifter, c0 <- lane M)
//   B'[j]    = base[min(j, last)]        (chain._tail_replicated)
//   D[s]     = sum_i i (B'[min(s+i, F-1)] - B'[max(s-i, 0)]) / denom,
//              denom = 2 sum_i i^2         (chain.delta)
//   DD[s]    = the same on D' = D with rows >= nv replaced by D[last]
//   out[s]   = [base | D | DD][s] for s < nv, else exactly 0
// and then, for cmvn == "utterance", a second launch (cmvn_kernel): per
// column, mu = sum_{s<nv} out / max(nv, 1), var = sum_{s<nv} (out - mu)^2 /
// max(nv, 1), out = (out - mu) / sqrt(var + eps) on rows s < nv
// (chain.cmvn_utterance; without cmvn_var_norm only the mean).
//
// Bound at the main path (classic13_deltas, b64 x 10 s, F = 999, M1 = 27,
// C = 13, 39 output lanes, 56,741 valid frames; H100 SXM peaks): it reads
// the 6.13 MB of prefix rows of valid frames (it never reads a row past
// n_valid) and writes 9.97 MB of features (pad rows zeroed), 16.10 MB ->
// 4.81 us at 3.35 TB/s; its 887 FLOP a valid frame (2 M1 C for the matmul,
// 2 C (3N + 1) for the two delta orders, 3 for the energy lane) give
// 0.75 us at 67 TFLOP/s fp32. The bytes set the bound;
// chip_smoke.py computes it from each run's inputs.
//
// Design. The kernel is a copy with a little arithmetic on the way, so it
// is built to keep the memory busy: few, large tiles whose halo is a few
// percent of what they read, copies that are all in flight at once, and
// 16-byte stores.
//   Tiles. One block per (utterance, tile of kTileMax = 128 frames), 256
//   threads (64 and 32 frames only for a generic shape whose 128-frame
//   layout is over the block; kernels/tail.py plan). A tile needs base at
//   the frames [f0 - 2N, f0 + 128 + 2N) clamped to [0, last]: the distinct
//   prefix rows q in [q_lo, q_hi] = [max(f0 - h, 0), min(f0 + 127 + h,
//   last)], h = deltas * N, one contiguous run of the utterance's rows. The
//   halo is 2h of 128 rows (6 % at N = 2), where 32-frame tiles re-read 25 %.
//   Both replication rules are clamps of the read index: base at position
//   q is row clamp(q, 0, last), D' at p is D[clamp(p, 0, last)], and a read
//   at s + i or s - i clamps the same way (last <= F - 1).
//   1. Staging: the run of rows is copied with cp.async, every copy issued
//      before any is waited for: for odd M1, 16 bytes a copy from the
//      16-byte boundary at or below its first float (scalar loads where the
//      rows are not 16-byte aligned, and past the tensor's end); for even
//      M1 (24 at kaldi_mfcc), 4 bytes a copy into rows padded to M1 + 1.
//   2. base, one thread per distinct row: the row's M1 values (rows an odd
//      stride apart: the lanes' rows lie in distinct banks), the energy lane logged, then
//      C accumulators of fp32 FMAs in lane order (m = 0 .. M1-1), as the
//      parent kernel and the torch matmul's order-free sum allow. For the
//      named shapes (M1, C, N, deltas) = (27, 13, 2, 2), (27, 13, -, 0) and
//      (24, 13, -, 0), the instantiation fixes them at compile time: the
//      loops unroll, every index is an immediate, and dct_aug rides in the
//      kernel's parameter space, so each FMA takes its weight as a constant
//      operand (a broadcast from the constant cache) and the product reads
//      no shared memory but the row. The generic instantiation (any other
//      shape: run-time M1, C, N, deltas) logs each row's energy lane in
//      place, then takes one (row, column) a thread, the same FMA chain in
//      lane order, so a wide shape (140 cepstra: 21,140 FMAs a row) spreads
//      over the block's threads and not over one thread a row; it reads
//      dct_aug staged in shared memory (coalesced over the columns).
//   3. D at the distinct positions [max(f0 - e, 0), min(f0 + 127 + e,
//      last)] (e = N for DD, 0 else), then DD at the tile's rows, one
//      thread per (position, column), each into shared memory (DD over the
//      staged rows, free by then).
//   4. The tile's [rows, 39] output, flat: 16-byte stores from the 16-byte
//      boundary of the output (scalar stores for the head and tail of the
//      run), each thread writing 4 consecutive floats, each one shared load
//      (base, D or DD), 0 past nv: no lane of a warp waits on another's
//      delta sum.
// The delta sums use __fmul_rn / __fadd_rn, so nvcc contracts none of them
// into an FMA: they round as the torch version's separate kernels do. base
// is the same FMA chain as the parent's 32-frame kernel, so the two agree
// bitwise. A tile wholly past nv writes zeros and reads nothing. Nothing but
// the [B, F, D] features reaches device memory.
//
// Plans for the generic shape (kernels/tail.py plan, plan_tail below): the
// first of 128, 64 and 32 frames a block whose layout fits the block
// (tiled); else the split, where dct_aug, the staged rows and their halo
// of 2 deltas N frames are over the block (170 cepstra at delta window 8:
// 236,256 B at 32 frames; 200 at window 40: 558,400 B). The split stages
// nothing, and reads dct_aug through __ldg: pass 0 writes base
// into the output's first C columns of each row below nv (zeros across the
// rows past it: the mask), pass 1 reads base from there and writes D into
// columns [C, 2C), pass 2 reads D and writes DD into [2C, 3C), each one
// thread per (row, column), a launch each (one pass's reads need its
// neighbours' writes from the pass before). Each value is the arithmetic of
// the tiled kernel's on the same inputs (the same FMA chain for base, the
// same delta_sum and clamps), so the plans agree bitwise, up to kChainLanes
// lanes. It reads each prefix row C times from L2 and each base and D value
// 2N times, where the tiled kernel reads them once from shared memory.
// Past kChainLanes lanes (the split alone takes such shapes: from ~1,100
// filters) base is a kernel of its own, tail_base_kernel (pass 0; the Δ and
// ΔΔ passes are the split's, so a step stays 1 + deltas launches). The FMA
// chain's error grows with its partial sums, which thousands of empty and
// one-weight filters (each lane the log floor, or one low bin's log power)
// drive up together: at 40,000 filters a chain read 9.3e-3 from the float64
// plain version (gate 2.3e-3), and chains over stretches of 256 or 16 lanes
// with the stretches added exactly stay over the gate's hundredth (a numpy
// emulation, tests/test_torch_wide.py), so every lane joins a compensated
// (Kahan) sum, ~5e-6. A block takes a tile of kBaseTile frames
// and kBaseCols cepstra (grid.z the rest; the columns past C zeros) and sweeps
// the lanes: warp w takes stretches w, w + 8, ... of kStretch lanes,
// kBaseLanes at a time, each chunk of the tile's rows staged by 16-byte
// cp.async copies (from the 16-byte boundary at or below the row's lane,
// whatever the row's alignment) beside dct_aug's chunk, double-buffered, so
// each prefix row is read once and dct_aug once a tile (not once a frame); a
// lane keeps kBaseRows frames x 4 cepstra of (sum, compensation) pairs. The
// warps' sums are added in float64 in warp order, a fixed order with no
// atomics, rounded once, and the energy lane's product added as the chain
// does. Bound at classic13_deltas with 60,000 filters, b16 x 10 s: the
// 3.84 GB prefix read once, ~1.15 ms at 3.35 TB/s; its 4 FP32 operations a
// term (12.5 G terms, padded to 16 cepstra 15.4 G) ~2.1 ms at the FP32 issue
// rate: the compensation, not the bytes, sets its floor.
//
// CMVN needs a reduction over the whole utterance, which no tile holds, so it
// is a second launch: one block per utterance, 8 warps; lane j of a warp takes
// column c0 + j, warp w rows w, w + 8, ... (coalesced row reads); the 8
// partial sums are added in warp order. Two passes (sums, then centred
// squares), then the rows are normalized in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileMax = 128;  // frames per block (the generic shape may take 64 or 32)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 27 * 13;  // dct_aug entries the parameter space holds (the named shapes)
constexpr int kSmemBudget = 232448;  // the H100's dynamic shared memory a block
constexpr int kChainLanes = 1024;    // the split's base: a plain FMA chain up to here, then tail_base_kernel
// tail_base_kernel: frames a block, lanes a warp's chunk, floats a staged row
// of it (from the 16-byte boundary at or below its first lane), lanes a
// stretch (the warps take them in turn), cepstra a block (grid.z takes the
// rest), a warp's stages and the floats of one stage (the rows, then
// dct_aug's chunk) and of a warp's stages
constexpr int kBaseTile = 64;
constexpr int kBaseLanes = 32;
constexpr int kBaseRow = kBaseLanes + 4;
constexpr int kStretch = 256;
constexpr int kBaseCols = 16;
constexpr int kBaseStages = 2;
constexpr int kBaseStage = kBaseTile * kBaseRow + kBaseLanes * kBaseCols;
constexpr int kBaseWarp = kBaseStages * kBaseStage;
constexpr int kBaseRows = kBaseTile / 8;  // frames a lane: fg + 8i, i < kBaseRows
static_assert(kStretch % kBaseLanes == 0, "a stretch is whole chunks");
static_assert(kWarps * kBaseTile * kBaseCols * 2 <= kWarps * kBaseWarp, "the warps' sums fit the stages");

struct TailParams {
  int F, M1, C, deltas, N, tile;
  int split;  // the generic shape's plan: 0 tiled, 1 the split
  int pass;   // the split's pass: 0 base, 1 D, 2 DD
  int append_energy, has_floor;
  int aligned_in, aligned_out;  // the prefix and out pointers are 16-byte aligned
  long long total;              // floats of the prefix tensor
  float eps, log_floor, denom;
  float w[kMaxW];  // dct_aug [M1][C], row-major, for the named shapes
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Shared memory of one tail block, in floats (kernels/tail.py smem_bytes
// mirrors it): dct_aug [M1][C] for the generic shape only, the staged prefix
// rows [R][M1 | 1] (odd M1 copied 16 bytes at a time from the boundary
// below, so up to 6 floats more; even M1 a float at a time into rows padded
// to the odd stride M1 + 1, so the rows a warp reads fall in distinct
// banks), which DD [tile][C] overlays once base is formed, their base
// cepstra [R][C], and D [RD][C].
struct TailLayout {
  int w, x, base, d, total;
};
__host__ __device__ inline TailLayout tail_layout(const TailParams& p, bool generic) {
  const int h = p.deltas * p.N;
  const int R = p.tile + 2 * h;
  const int RD = p.deltas == 0 ? 0 : p.tile + 2 * (p.deltas >= 2 ? p.N : 0);
  TailLayout l;
  l.w = 0;
  l.x = generic ? align4(p.M1 * p.C) : 0;
  l.base = l.x + align4(R * (p.M1 | 1) + 6 > p.tile * p.C ? R * (p.M1 | 1) + 6 : p.tile * p.C);
  l.d = l.base + R * p.C;
  l.total = l.d + RD * p.C;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// The energy lane of a prefix row, logged and floored under append_energy.
__device__ __forceinline__ float energy_lane(float v, const TailParams& p) {
  if (p.append_energy) {
    v = logf(v <= 0.f ? p.eps : v);
    if (p.has_floor) v = fmaxf(v, p.log_floor);
  }
  return v;
}

// sum_{k=1..N} k (v(c + k) - v(c - k)) / denom, each term rounded on its own
// (no contraction), v(j) read at clamp(j, 0, last).
template <typename At>
__device__ __forceinline__ float delta_sum(int c, int N, int last, float denom, const At& at) {
  float acc = 0.f;
  for (int k = 1; k <= N; ++k) {
    const float diff = __fsub_rn(at(min(c + k, last)), at(max(c - k, 0)));
    acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(k), diff));
  }
  return acc / denom;
}

// kM1, kC, kN, kDeltas > 0 fix the shape at compile time (kDeltas == 0 with
// kM1 > 0: no deltas, N unused); kM1 == 0 is the generic instantiation.
template <int kM1, int kC, int kN, int kDeltas>
__global__ void __launch_bounds__(kThreads)
tail_kernel(const float* __restrict__ prefix, const int* __restrict__ n_valid,
            const float* __restrict__ dct, float* __restrict__ out,
            const __grid_constant__ TailParams p) {
  constexpr bool kGeneric = kM1 == 0;
  extern __shared__ __align__(16) float smem[];
  const int M1 = kGeneric ? p.M1 : kM1;
  const int C = kGeneric ? p.C : kC;
  const int deltas = kGeneric ? p.deltas : kDeltas;
  const int N = kGeneric ? p.N : (kDeltas > 0 ? kN : 0);
  const int Dout = C * (deltas + 1);
  const int F = p.F, tile = kGeneric ? p.tile : kTileMax;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile;
  const int nv = min(max(n_valid[b], 0), F);
  const int rows = min(tile, F - f0);
  const long long go = (static_cast<long long>(b) * F + f0) * Dout;  // the tile's first output float
  const int n_out = rows * Dout;
  // 4. the tile's output in 16-byte stores: floats [0, head) and [n_out -
  //    tail_n, n_out) one at a time, the rest four at a time
  const int head = p.aligned_out ? min(static_cast<int>((4 - (go & 3)) & 3), n_out) : n_out;
  const int quads = (n_out - head) >> 2;
  auto store_tile = [&](const auto& value) {
    float* o = out + go;
    for (int q = threadIdx.x; q < quads; q += kThreads) {
      const int i = head + 4 * q;
      float4 v;
      v.x = value(i);
      v.y = value(i + 1);
      v.z = value(i + 2);
      v.w = value(i + 3);
      *reinterpret_cast<float4*>(o + i) = v;
    }
    for (int i = threadIdx.x; i < head; i += kThreads) o[i] = value(i);
    for (int i = head + 4 * quads + threadIdx.x; i < n_out; i += kThreads) o[i] = value(i);
  };
  if (f0 >= nv) {  // the whole tile is padding
    store_tile([](int) { return 0.f; });
    return;
  }
  const int last = nv - 1;  // >= f0 >= 0 here
  const int h = deltas * N;
  const int e = deltas >= 2 ? N : 0;  // D is needed at [f0 - e, f0 + tile + e)
  const int q_lo = max(f0 - h, 0), q_hi = min(f0 + tile - 1 + h, last);
  const int d_lo = max(f0 - e, 0), d_hi = min(f0 + tile - 1 + e, last);
  const TailLayout lay = tail_layout(p, kGeneric);
  float* w = smem + lay.w;
  float* base = smem + lay.base;  // row q at (q - q_lo) * C
  float* d1 = smem + lay.d;       // D at position c at (c - d_lo) * C

  // 1. the rows [q_lo, q_hi] by cp.async: odd M1 from the 16-byte boundary
  //    below, 16 bytes a copy; even M1 a float a copy into rows M1 + 1 apart
  const int XS = M1 | 1;  // the staged rows' stride
  const long long flat = (static_cast<long long>(b) * F + q_lo) * M1;
  const int n = (q_hi - q_lo + 1) * M1;
  const int shift = XS == M1 ? static_cast<int>(flat & 3) : 0;
  const float* x = smem + lay.x + shift;  // row q at (q - q_lo) * XS
  {
    float* xs = smem + lay.x;
    if (XS == M1) {
      const long long fa = flat - shift;
      const int nvec = (n + shift + 3) >> 2;
      for (int v = threadIdx.x; v < nvec; v += kThreads) {
        const long long f = fa + 4 * v;
        if (p.aligned_in && f + 4 <= p.total) {
          copy16(xs + 4 * v, prefix + f);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) xs[4 * v + k] = f + k < p.total ? prefix[f + k] : 0.f;
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int r = i / M1;
        copy4(xs + r * XS + (i - r * M1), prefix + flat + i);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if constexpr (kGeneric) {
      for (int i = threadIdx.x; i < M1 * C; i += kThreads) w[i] = dct[i];
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();

  // 2. base for every distinct row, an FMA chain in lane order per column
  const int nrows = q_hi - q_lo + 1;
  if constexpr (kGeneric) {
    // the energy lane logged in place, then one (row, column) a thread
    float* xw = smem + lay.x + shift;
    for (int r = threadIdx.x; r < nrows; r += kThreads) {
      xw[r * XS + M1 - 1] = energy_lane(xw[r * XS + M1 - 1], p);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nrows * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      const float* xr = x + r * XS;
      float acc = 0.f;
      for (int m = 0; m < M1 - 1; ++m) acc = fmaf(xr[m], w[m * C + c], acc);
      base[i] = fmaf(xr[M1 - 1], w[(M1 - 1) * C + c], acc);
    }
  } else {
    for (int r = threadIdx.x; r < nrows; r += kThreads) {
      const float* xr = x + r * XS;
      float* br = base + r * C;
      float xv[kM1];
#pragma unroll
      for (int m = 0; m < kM1; ++m) xv[m] = xr[m];
      xv[kM1 - 1] = energy_lane(xv[kM1 - 1], p);
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.f;
#pragma unroll
      for (int m = 0; m < kM1; ++m) {
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = fmaf(xv[m], p.w[m * kC + c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) br[c] = acc[c];
    }
  }
  __syncthreads();

  // 3. D at the distinct positions [d_lo, d_hi], one (position, column) a thread
  if (deltas >= 1) {
    const int nd = (d_hi - d_lo + 1) * C;
    for (int i = threadIdx.x; i < nd; i += kThreads) {
      const int r = i / C, c = i - r * C;
      d1[i] = delta_sum(d_lo + r, N, last, p.denom,
                        [&](int j) { return base[(j - q_lo) * C + c]; });
    }
    __syncthreads();
  }

  // 3b. DD at the tile's rows below nv, one (row, column) a thread, over
  //     the staged rows (free since step 2)
  float* dd = smem + lay.x;  // row s at (s - f0) * C
  if (deltas >= 2) {
    const int n_dd = (min(f0 + rows, nv) - f0) * C;
    for (int i = threadIdx.x; i < n_dd; i += kThreads) {
      const int r = i / C, c = i - r * C;
      dd[i] = delta_sum(f0 + r, N, last, p.denom, [&](int j) { return d1[(j - d_lo) * C + c]; });
    }
    __syncthreads();
  }

  // 4. [base | D | DD] of the tile's rows below nv, 0 past it: each float
  //    one shared load
  store_tile([&](int i) -> float {
    const int r = i / Dout, col = i - r * Dout;
    const int s = f0 + r;
    if (s >= nv) return 0.f;
    if (col < C) return base[(s - q_lo) * C + col];
    if (col < 2 * C) return d1[(s - d_lo) * C + col - C];
    return dd[r * C + col - 2 * C];
  });
}

// The split, pass p.pass over row b = blockIdx.y, one thread per
// (frame s, column): pass 0 over all Dout columns (base into [0, C) below
// nv, zeros at and past nv), pass 1 over C (D into [C, 2C) from base),
// pass 2 over C (DD into [2C, 3C) from D), each below nv only. Past
// kChainLanes lanes tail_base_kernel takes pass 0.
__global__ void __launch_bounds__(kThreads)
tail_split_kernel(const float* __restrict__ prefix, const int* __restrict__ n_valid,
                  const float* __restrict__ dct, float* __restrict__ out, const TailParams p) {
  const int F = p.F, M1 = p.M1, C = p.C, N = p.N;
  const int Dout = C * (p.deltas + 1);
  const int width = p.pass == 0 ? Dout : C;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(F) * width) return;
  const int s = static_cast<int>(i / width), col = static_cast<int>(i - static_cast<long long>(s) * width);
  const int b = blockIdx.y;
  const int nv = min(max(n_valid[b], 0), F), last = nv - 1;
  float* o = out + static_cast<size_t>(b) * F * Dout;
  if (p.pass == 0) {
    if (s >= nv) {
      o[static_cast<size_t>(s) * Dout + col] = 0.f;
    } else if (col < C) {  // the generic kernel's FMA chain in lane order
      const float* xr = prefix + (static_cast<size_t>(b) * F + s) * M1;
      float acc = 0.f;
      for (int m = 0; m < M1 - 1; ++m) acc = fmaf(__ldg(xr + m), __ldg(dct + m * C + col), acc);
      o[static_cast<size_t>(s) * Dout + col] =
          fmaf(energy_lane(__ldg(xr + M1 - 1), p), __ldg(dct + (M1 - 1) * C + col), acc);
    }
    return;
  }
  if (s >= nv) return;
  const int from = (p.pass - 1) * C + col;  // base (pass 1) or D (pass 2) of this column
  o[static_cast<size_t>(s) * Dout + from + C] =
      delta_sum(s, N, last, p.denom, [&](int j) { return o[static_cast<size_t>(j) * Dout + from]; });
}

// The split's base past kChainLanes lanes (pass 0; see the header): a tile
// of kBaseTile frames of row blockIdx.y, cepstra [c0, c0 + kBaseCols), c0 =
// kBaseCols blockIdx.z, a block. Warp w sweeps stretches w, w + 8, ... of
// kStretch lanes, kBaseLanes at a time through kBaseStages stages of its
// own: the chunk of the tile's rows below nv by 16-byte cp.async copies
// (each row's from the 16-byte boundary at or below its first lane, so a
// row starts `shift` floats in) and dct_aug's rows of the chunk by 4-byte
// ones (its columns past C staged as zeros once). Lane (fg, cg) keeps
// kBaseRows frames (fg + 8i) x 4 cepstra (4 cg + j) of compensated (Kahan) sums over
// the warp's lanes in order; the warps' sums (acc - comp, in float64) are
// then added in warp order, rounded once, and the energy lane's product
// added as the split does. The first column block also writes the zeros of
// the tile's rows at and past nv.
__global__ void __launch_bounds__(kThreads, 1)
tail_base_kernel(const float* __restrict__ prefix, const int* __restrict__ n_valid,
                 const float* __restrict__ dct, float* __restrict__ out, const __grid_constant__ TailParams p) {
  extern __shared__ __align__(16) float smem[];
  const int F = p.F, M1 = p.M1, C = p.C, Dout = C * (p.deltas + 1);
  const int b = blockIdx.y, f0 = blockIdx.x * kBaseTile, c0 = blockIdx.z * kBaseCols;
  const int nv = min(max(n_valid[b], 0), F);
  const int rows = min(kBaseTile, F - f0);
  float* o = out + static_cast<size_t>(b) * F * Dout;
  if (blockIdx.z == 0) {  // the mask: every column of the tile's rows at and past nv
    for (int i = threadIdx.x; i < rows * Dout; i += kThreads) {
      if (f0 + i / Dout >= nv) o[static_cast<size_t>(f0) * Dout + i] = 0.f;
    }
  }
  const int live = min(rows, nv - f0);  // the tile's rows below nv
  if (live <= 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fg = lane >> 2, cg = lane & 3;
  const int lanes = M1 - 1;  // the sweep's (the energy lane apart)
  const int per = kStretch / kBaseLanes;  // chunks a stretch
  const int stretches = (lanes + kStretch - 1) / kStretch;
  const int chunks = (stretches > warp ? (stretches - warp + kWarps - 1) / kWarps : 0) * per;
  float* ws = smem + warp * kBaseWarp;
  const long long row0 = (static_cast<long long>(b) * F + f0) * M1;  // the tile's first row
  const long long at = static_cast<long long>(reinterpret_cast<uintptr_t>(prefix) >> 2);
  auto shift_of = [&](int r) { return static_cast<int>((at + row0 + static_cast<long long>(r) * M1) & 3); };
  auto lane0 = [&](int c) { return (warp + kWarps * (c / per)) * kStretch + (c % per) * kBaseLanes; };
  auto nlanes = [&](int c) { return min(kBaseLanes, lanes - lane0(c)); };  // <= 0 past the last stretch's end
  auto copy_chunk = [&](int c) {
    const int k0 = lane0(c), nl = nlanes(c);
    float* xs = ws + (c & 1) * kBaseStage;
    float* ds = xs + kBaseTile * kBaseRow;
    if (nl > 0) {
      for (int i = lane; i < live * (kBaseRow / 4); i += 32) {
        const int r = i / (kBaseRow / 4), q = i - r * (kBaseRow / 4);
        const int sh = shift_of(r);
        if (4 * q < sh + nl) copy16(xs + r * kBaseRow + 4 * q, prefix + row0 + static_cast<long long>(r) * M1 + k0 - sh + 4 * q);
      }
      for (int i = lane; i < nl * kBaseCols; i += 32) {
        const int m = i / kBaseCols, j = i - m * kBaseCols;
        if (c0 + j < C) copy4(ds + i, dct + static_cast<size_t>(k0 + m) * C + c0 + j);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int st = 0; st < kBaseStages; ++st) {  // dct_aug's columns past C: zeros, never copied over
    float* ds = ws + st * kBaseStage + kBaseTile * kBaseRow;
    for (int i = lane; i < kBaseLanes * kBaseCols; i += 32) {
      if (c0 + (i & (kBaseCols - 1)) >= C) ds[i] = 0.f;
    }
  }
  int xoff[kBaseRows];  // this lane's frames' rows in a stage, each from its shift
#pragma unroll
  for (int i = 0; i < kBaseRows; ++i) {
    const int r = fg + 8 * i;
    xoff[i] = r * kBaseRow + (r < live ? shift_of(r) : 0);
  }
  float acc[kBaseRows][4], comp[kBaseRows][4];  // comp: the low bits acc has lost
#pragma unroll
  for (int i = 0; i < kBaseRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = comp[i][j] = 0.f;
  }
  auto add = [](float& s, float& c, float x, float w) {
    const float y = fmaf(x, w, -c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  };
  if (chunks > 0) copy_chunk(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      copy_chunk(c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();  // every lane's copies of chunk c are in
    const float* xs = ws + (c & 1) * kBaseStage;
    const float* ds = xs + kBaseTile * kBaseRow;
    const int nl = nlanes(c);
    for (int m = 0; m < nl; ++m) {
      const float4 d = *reinterpret_cast<const float4*>(ds + m * kBaseCols + 4 * cg);
#pragma unroll
      for (int i = 0; i < kBaseRows; ++i) {
        const float x = xs[xoff[i] + m];
        add(acc[i][0], comp[i][0], x, d.x);
        add(acc[i][1], comp[i][1], x, d.y);
        add(acc[i][2], comp[i][2], x, d.z);
        add(acc[i][3], comp[i][3], x, d.w);
      }
    }
    __syncwarp();  // the stage is rewritten by chunk c + 2's copies
  }
  __syncthreads();  // every warp's sweep is done: the stages hold the warps' sums
  double* red = reinterpret_cast<double*>(smem);  // [warp][frame][column]
#pragma unroll
  for (int i = 0; i < kBaseRows; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[(warp * kBaseTile + fg + 8 * i) * kBaseCols + 4 * cg + j] =
          static_cast<double>(acc[i][j]) - static_cast<double>(comp[i][j]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < live * kBaseCols; e += kThreads) {
    const int r = e / kBaseCols, col = c0 + e - r * kBaseCols;
    if (col >= C) continue;
    double t = red[r * kBaseCols + col - c0];
    for (int w = 1; w < kWarps; ++w) t += red[(w * kBaseTile + r) * kBaseCols + col - c0];
    const float* xr = prefix + row0 + static_cast<long long>(r) * M1;
    o[static_cast<size_t>(f0 + r) * Dout + col] =
        fmaf(energy_lane(__ldg(xr + M1 - 1), p), __ldg(dct + static_cast<size_t>(M1 - 1) * C + col),
             static_cast<float>(t));
  }
}

// Utterance CMVN in place over the valid rows of feat [B, F, D].
__global__ void __launch_bounds__(kThreads)
cmvn_kernel(float* __restrict__ feat, const int* __restrict__ n_valid, int F, int D,
            int var_norm, float eps) {
  __shared__ float part[kWarps][32];
  __shared__ float stat[2][32];  // mean, sqrt(var + eps)
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = min(max(n_valid[b], 0), F);
  const float n = static_cast<float>(max(nv, 1));
  float* x = feat + static_cast<size_t>(b) * F * D;
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < D;
    float acc = 0.f;
    if (on) {
      for (int s = warp; s < nv; s += kWarps) acc += x[static_cast<size_t>(s) * D + c];
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0) {
      float tot = 0.f;
      for (int k = 0; k < kWarps; ++k) tot += part[k][lane];
      stat[0][lane] = tot / n;
      stat[1][lane] = 1.f;
    }
    __syncthreads();
    const float mu = stat[0][lane];
    if (var_norm) {
      float sq = 0.f;
      if (on) {
        for (int s = warp; s < nv; s += kWarps) {
          const float d = x[static_cast<size_t>(s) * D + c] - mu;
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
      part[warp][lane] = sq;
      __syncthreads();
      if (warp == 0) {
        float tot = 0.f;
        for (int k = 0; k < kWarps; ++k) tot += part[k][lane];
        stat[1][lane] = sqrtf(tot / n + eps);
      }
      __syncthreads();
    }
    const float sd = stat[1][lane];
    if (on) {
      for (int s = warp; s < nv; s += kWarps) {
        float* v = x + static_cast<size_t>(s) * D + c;
        *v = var_norm ? (*v - mu) / sd : *v - mu;
      }
    }
    __syncthreads();  // part and stat are rewritten by the next column chunk
  }
}

// The launch of one instantiation at p.tile frames a block.
template <int kM1, int kC, int kN, int kDeltas>
cudaError_t launch(const float* prefix, const int* n_valid, const float* dct, float* out, int B,
                   const TailParams& p, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(tail_layout(p, kM1 == 0).total) * sizeof(float);
  auto kernel = tail_kernel<kM1, kC, kN, kDeltas>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.F + p.tile - 1) / p.tile, B);
  kernel<<<grid, kThreads, bytes, stream>>>(prefix, n_valid, dct, out, p);
  return cudaGetLastError();
}

// The named shapes fixed at compile time: (M1, C, N, deltas).
inline int shape_of(int M1, int C, int N, int deltas) {
  if (M1 == 27 && C == 13 && deltas == 2 && N == 2) return 1;
  if (M1 == 27 && C == 13 && deltas == 0) return 2;
  if (M1 == 24 && C == 13 && deltas == 0) return 3;
  return 0;
}

// The tail's plan for a shape (kernels/tail.py plan): the named shapes
// tiled at 128 frames a block; for the generic one the first of 128, 64
// and 32 frames whose layout fits the block, else the split (no tile).
inline void plan_tail(TailParams& p) {
  p.split = 0;
  p.tile = kTileMax;
  if (shape_of(p.M1, p.C, p.N, p.deltas) != 0) return;
  for (; p.tile >= 32; p.tile /= 2) {
    if (tail_layout(p, true).total * 4 <= kSmemBudget) return;
  }
  p.split = 1;
  p.tile = 0;
}

// The split's passes: base and the mask (tail_base_kernel past kChainLanes
// lanes), then one pass a delta order.
cudaError_t launch_split(const float* prefix, const int* n_valid, const float* dct, float* out,
                         int B, TailParams p, cudaStream_t stream) {
  for (p.pass = 0; p.pass <= p.deltas; ++p.pass) {
    if (p.pass == 0 && p.M1 - 1 > kChainLanes) {
      const int bytes = kWarps * kBaseWarp * static_cast<int>(sizeof(float));
      const cudaError_t err = cudaFuncSetAttribute(tail_base_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   bytes);
      if (err != cudaSuccess) return err;
      const dim3 grid((p.F + kBaseTile - 1) / kBaseTile, B, (p.C + kBaseCols - 1) / kBaseCols);
      tail_base_kernel<<<grid, kThreads, bytes, stream>>>(prefix, n_valid, dct, out, p);
    } else {
      const long long n = static_cast<long long>(p.F) * (p.pass == 0 ? p.C * (p.deltas + 1) : p.C);
      const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), B);
      tail_split_kernel<<<grid, kThreads, 0, stream>>>(prefix, n_valid, dct, out, p);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches the tail on `stream`; returns cudaGetLastError() (0 = launched).
// prefix [B, F, M1] float32; n_valid [B] int32; dct [M1, C] float32 on the
// card and dct_host its host copy (constants.dct_augmented; the named shapes
// carry it in the kernel's parameters, the generic one reads the card's);
// out [B, F, C * (deltas + 1)] float32. deltas 0-2, delta_window N >= 1 when
// deltas > 0, denom = 2 sum_{i<=N} i^2; log_floor = ln(energy_floor) used
// when has_floor != 0.
int mfcc_feature_tail(const float* prefix, const int* n_valid, const float* dct,
                      const float* dct_host, float* out, int B, int F, int M1, int C, int deltas,
                      int N, int append_energy, int has_floor, float eps, float log_floor,
                      float denom, void* stream) {
  if (B < 1 || B > 65535 || F < 1 || M1 < 1 || C < 1 || deltas < 0 || deltas > 2 ||
      (deltas > 0 && (N < 1 || !(denom > 0.f))) || dct == nullptr) {
    return cudaErrorInvalidValue;
  }
  TailParams p{};
  p.F = F;
  p.M1 = M1;
  p.C = C;
  p.deltas = deltas;
  p.N = deltas > 0 ? N : 0;
  p.append_energy = append_energy;
  p.has_floor = has_floor;
  p.aligned_in = (reinterpret_cast<uintptr_t>(prefix) & 15) == 0;
  p.aligned_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  p.total = static_cast<long long>(B) * F * M1;
  p.eps = eps;
  p.log_floor = log_floor;
  p.denom = denom;
  plan_tail(p);
  const int shape = shape_of(M1, C, N, deltas);
  if (shape != 0) {
    if (dct_host == nullptr) return cudaErrorInvalidValue;
    for (int i = 0; i < M1 * C; ++i) p.w[i] = dct_host[i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.split) return launch_split(prefix, n_valid, dct, out, B, p, s);
  switch (shape) {
    case 1:
      return launch<27, 13, 2, 2>(prefix, n_valid, dct, out, B, p, s);
    case 2:
      return launch<27, 13, 0, 0>(prefix, n_valid, dct, out, B, p, s);
    case 3:
      return launch<24, 13, 0, 0>(prefix, n_valid, dct, out, B, p, s);
    default:
      return launch<0, 0, 0, 0>(prefix, n_valid, dct, out, B, p, s);
  }
}

// Utterance CMVN of feat [B, F, D] float32 in place, over rows s < n_valid[b].
int mfcc_feature_tail_cmvn(float* feat, const int* n_valid, int B, int F, int D, int var_norm,
                           float eps, void* stream) {
  if (B < 1 || F < 1 || D < 1) return cudaErrorInvalidValue;
  cmvn_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(feat, n_valid, F, D,
                                                                     var_norm, eps);
  return cudaGetLastError();
}

const char* mfcc_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
