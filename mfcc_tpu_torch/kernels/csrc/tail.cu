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
// Design. One block per (utterance, tile of 32 frames), 256 threads, the
// front-end kernel's tiling. A tile needs base rows [f0 - 2N, f0 + 32 + 2N)
// (N per delta order). Both replication rules happen at load time: staged
// row q holds the prefix row clamp(q, 0, last), so a read at the unclipped
// position s +- i equals B'[min(s+i, F-1)] or B'[max(s-i, 0)] (last <= F-1).
// The block stages those prefix rows and dct_aug in shared memory, computes
// base for every staged row (an fp32 FMA sum in lane order over the M1
// terms: no tensor cores, no TF32), then D at positions [f0 - N, f0 + 32 +
// N), each read at clamp(p, 0, last) (that is D'), then DD and the mask for
// the tile's rows. The delta sums use __fmul_rn / __fadd_rn, so nvcc
// contracts none of them into an FMA: they round as the torch version's
// separate kernels do. A tile wholly past nv writes zeros and reads
// nothing. Every thread's work is a few hundred FLOP, so the kernel is
// bound by its launch and its memory traffic; nothing but the [B, F, D]
// features reaches device memory.
//
// CMVN needs a reduction over the whole utterance, which no tile holds, so it
// is a second launch: one block per utterance, 8 warps; lane j of a warp takes
// column c0 + j, warp w rows w, w + 8, ... (coalesced row reads); the 8
// partial sums are added in warp order. Two passes (sums, then centred
// squares), then the rows are normalized in place.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;  // frames per block, as the front-end kernel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct TailParams {
  int F, M1, C, deltas, N;
  int append_energy, has_floor;
  float eps, log_floor, denom;
};

// Shared memory of one tail block, in floats: dct_aug [M1][C], the staged
// prefix rows [R][M1], their base cepstra [R][C], and D [RD][C].
// kernels/tail.py smem_bytes mirrors it.
__host__ __device__ inline int halo(const TailParams& p) { return p.deltas * p.N; }
__host__ __device__ inline int staged_rows(const TailParams& p) { return kTile + 2 * halo(p); }
__host__ __device__ inline int delta_rows(const TailParams& p) {
  return p.deltas == 0 ? 0 : kTile + 2 * (p.deltas >= 2 ? p.N : 0);
}
__host__ __device__ inline int tail_floats(const TailParams& p) {
  const int R = staged_rows(p);
  return p.M1 * p.C + R * p.M1 + R * p.C + delta_rows(p) * p.C;
}

__global__ void __launch_bounds__(kThreads)
tail_kernel(const float* __restrict__ prefix, const int* __restrict__ n_valid,
            const float* __restrict__ dct, float* __restrict__ out, TailParams p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTile;
  const int F = p.F, M1 = p.M1, C = p.C, N = p.N;
  const int D = C * (p.deltas + 1);
  const int nv = min(max(n_valid[b], 0), F);
  const int rows = min(kTile, F - f0);
  float* o = out + (static_cast<size_t>(b) * F + f0) * D;
  if (f0 >= nv) {  // the whole tile is padding
    for (int i = threadIdx.x; i < rows * D; i += kThreads) o[i] = 0.f;
    return;
  }
  const int last = nv - 1;  // >= f0 >= 0 here
  const int h = halo(p);
  const int R = staged_rows(p);
  const int e = p.deltas >= 2 ? N : 0;  // D is needed at [f0 - e, f0 + 32 + e)
  const int RD = delta_rows(p);
  float* w = smem;               // dct_aug [M1][C]
  float* x = w + M1 * C;         // staged prefix rows [R][M1], row r at position f0 - h + r
  float* base = x + R * M1;      // [R][C]
  float* d1 = base + R * C;      // D' [RD][C], row r at position f0 - e + r

  // 1. dct_aug and the prefix rows clamp(q, 0, last), the energy lane logged
  for (int i = threadIdx.x; i < M1 * C; i += kThreads) w[i] = dct[i];
  const float* row0 = prefix + static_cast<size_t>(b) * F * M1;
  for (int i = threadIdx.x; i < R * M1; i += kThreads) {
    const int r = i / M1, m = i - r * M1;
    const int q = min(max(f0 - h + r, 0), last);
    float v = row0[static_cast<size_t>(q) * M1 + m];
    if (p.append_energy && m == M1 - 1) {
      v = logf(v <= 0.f ? p.eps : v);
      if (p.has_floor) v = fmaxf(v, p.log_floor);
    }
    x[i] = v;
  }
  __syncthreads();

  // 2. base = x . dct_aug for every staged row, FMA in lane order
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const float* xr = x + r * M1;
    float acc = 0.f;
    for (int m = 0; m < M1; ++m) acc = fmaf(xr[m], w[m * C + c], acc);
    base[i] = acc;
  }
  __syncthreads();

  // 3. D' at positions p = f0 - e + r: D at c = clamp(p, 0, last), whose
  //    reads c +- i stay inside the staged rows
  for (int i = threadIdx.x; i < RD * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const int at = min(max(f0 - e + r, 0), last) - (f0 - h);
    float acc = 0.f;
    for (int k = 1; k <= N; ++k) {
      const float diff = __fsub_rn(base[(at + k) * C + c], base[(at - k) * C + c]);
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(k), diff));
    }
    d1[i] = acc / p.denom;
  }
  __syncthreads();

  // 4. the tile's rows: [base | D | DD] for s < nv, 0 past it
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, col = i - r * D;
    float v = 0.f;
    if (f0 + r < nv) {
      if (col < C) {
        v = base[(r + h) * C + col];
      } else if (col < 2 * C) {
        v = d1[(r + e) * C + col - C];
      } else {
        const int c = col - 2 * C;
        float acc = 0.f;
        for (int k = 1; k <= N; ++k) {
          const float diff = __fsub_rn(d1[(r + e + k) * C + c], d1[(r + e - k) * C + c]);
          acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(k), diff));
        }
        v = acc / p.denom;
      }
    }
    o[i] = v;
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

}  // namespace

extern "C" {

// Launches the tail on `stream`; returns cudaGetLastError() (0 = launched).
// prefix [B, F, M1] float32; n_valid [B] int32; dct [M1, C] float32
// (constants.dct_augmented); out [B, F, C * (deltas + 1)] float32. deltas 0-2,
// delta_window N >= 1 when deltas > 0, denom = 2 sum_{i<=N} i^2; log_floor =
// ln(energy_floor) used when has_floor != 0.
int mfcc_feature_tail(const float* prefix, const int* n_valid, const float* dct, float* out,
                      int B, int F, int M1, int C, int deltas, int N, int append_energy,
                      int has_floor, float eps, float log_floor, float denom, void* stream) {
  const TailParams p{F, M1, C, deltas, N, append_energy, has_floor, eps, log_floor, denom};
  if (B < 1 || B > 65535 || F < 1 || M1 < 1 || C < 1 || deltas < 0 || deltas > 2 ||
      (deltas > 0 && (N < 1 || !(denom > 0.f)))) {
    return cudaErrorInvalidValue;
  }
  const size_t bytes = static_cast<size_t>(tail_floats(p)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kTile - 1) / kTile, B);
  tail_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(prefix, n_valid, dct,
                                                                            out, p);
  return cudaGetLastError();
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
