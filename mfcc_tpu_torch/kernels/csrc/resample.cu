// Polyphase resampler for Hopper (sm_90a): int16 or float32 rows [B, T] at
// sr_in -> float32 [B, n_out] at sr_out, n_out = ceil(T * up / down); scipy
// resample_poly with constant (zero) padding. With per-row lengths, input
// at t >= lengths[b] reads as 0 (the plain chain's zero_beyond before its
// resample) and out_lengths[b] = ceil(lengths[b] * up / down): the first
// launch of the split route (kernels/frontend.py resample_route), whose
// second is the front-end's plain form on these rows.
//
// Replaces mfcc_tpu/kernels/resample.py::resample_pallas (:104, kernel
// _make_kernel :79, pallas_call :128), which takes integer decimation only;
// this kernel takes every ratio, so the JAX package's two-dot XLA path for
// 44.1 kHz, 8 kHz and any other ratio needs no port of its own. Plain
// version and wrappers: mfcc_tpu_torch/kernels/resample.py
// (resample_reference, polyphase_resample; resample_rows_reference,
// resample_rows).
//
// Bound at the main path's shapes (48 kHz -> 16 kHz, [64, 480,080] ->
// [64, 160,027]; H100 SXM peaks): bytes 122.9 MB in + 41.0 MB out = 164 MB
// -> 49 us at 3.35 TB/s; operations 91 FLOP per output (the 61 symmetric
// taps folded) = 0.93 GFLOP -> 14 us at 67 TFLOP/s fp32. Bytes bound it;
// chip_smoke.py computes the bound from each run's inputs.
//
// Design. Tiles of tile_out outputs of a row (at most kTileOut = 1,792, see
// "The plan" below); 256 threads a block,
// kPpR1 = 7 outputs a thread at up = 1 (one round a tile), kPpRU = 4 at up
// > 1. Blocks are persistent (the SMs times the blocks an SM holds), block
// k taking tiles k, k + grid, .... A block stages the tap table
// (polyphase.cuh's padded stride) once, and each tile's input window
// (pp_window samples) with cp.async 16-byte copies of the flat [B, T] array
// from the boundary at or below the window's flat index into one of two
// buffers: the next tile's copies run while the FIR computes the current
// one, so device-memory time and FIR time overlap, where one tile a block
// ran them one after the other. Vectors that would leave the array, and every one
// for a base pointer that is not 16-byte aligned, take scalar loads; the
// first and last tiles of a row zero their samples outside it once the
// copies land. polyphase.cuh's register-blocked FIR (pp_block) writes each
// output into a shared row, which the block stores coalesced. Every input
// byte is read about once from device memory (the halo between tiles is
// L2's).
//
// The plan (kernels/resample.py plan mirrors it; the host passes tile_out
// and the mode, and this file checks the layout against the budget), chosen
// for float32 windows so both row types take the same one:
//   mode 0: the table and two windows staged, at the largest tile_out, a
//     multiple of kTileStep = 224 (a warp's kPpR1 outputs a lane) up to
//     kTileOut, whose layout fits the block (192 kHz -> 8 kHz, down 24:
//     1,792 outputs would read two windows of 43,488 samples, so 1,120);
//   mode 1, where mode 0 fits at no tile (the table over what the windows
//     leave: 16,000 -> 15,999 has up = 16,000 phases of 21 taps, 1.34 MB):
//     the taps read from device memory through the read-only path
//     (PpGlobalTaps; L2 holds the table), the windows staged as in mode 0;
//     Mode 1 also takes down 114 to 118 at up = 1, at 224 outputs a tile;
//   mode 2, where even 224 outputs' windows do not fit (down 119 and over
//     at up = 1): the FIR reads both from device memory (PpGlobalWindow
//     masks at the row's length), and only the output row is staged.
// Modes 1 and 2 are simple and slow: no reuse of a tap across a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polyphase.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileOut = kPpR1 * kThreads;  // the largest tile (kernels/resample.py TILE_OUT)
constexpr int kTileStep = kPpR1 * 32;       // tiles are multiples of a warp's outputs
constexpr int kSmemBudget = 232448;         // the H100's dynamic shared memory a block
enum { kStaged = 0, kGlobalTaps = 1, kGlobalAll = 2 };  // kernels/resample.py MODES

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Shared memory, in floats: the table [up][pp_stride] (mode 0), two windows
// of Sample (pp_stage_floats: room for the alignment shift; modes 0 and 1),
// the output row.
struct Layout {
  int win, wstride, out, total;
};

template <typename Sample>
__host__ __device__ inline Layout layout(const Polyphase& pp, int tile, int mode) {
  Layout l;
  l.win = mode == kStaged ? align4(pp.up * pp_stride(pp)) : 0;
  l.wstride = mode == kGlobalAll ? 0 : pp_stage_floats<Sample>(pp_window(tile, pp));
  l.out = l.win + 2 * l.wstride;
  l.total = l.out + tile;
  return l;
}

// Tile t of the grid: its row, first output and outputs.
struct Tile {
  int b, n;
  long long j0, lo;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_a_row, int tile, int n_out,
                                        const Polyphase& pp) {
  Tile tl;
  tl.b = t / tiles_a_row;
  tl.j0 = static_cast<long long>(t - tl.b * tiles_a_row) * tile;
  tl.n = static_cast<int>(min(static_cast<long long>(tile), n_out - tl.j0));
  tl.lo = pp_first_input(tl.j0, pp);
  return tl;
}

// Row b's valid input samples: lengths[b] clamped to [0, T], or T.
__device__ __forceinline__ long long row_length(const int* lengths, int b, int T) {
  return lengths ? min(static_cast<long long>(T), max(0LL, static_cast<long long>(lengths[b]))) : T;
}

// Persistent: block k takes tiles k, k + grid, ...; in modes 0 and 1 the
// next tile's window copies run while the FIR computes the current one (two
// window buffers). The first tile of a row writes its output length.
template <typename Sample, int kMode>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const Sample* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ table, const int* __restrict__ lengths,
                int* __restrict__ out_lengths, int B, int T, int n_out, int tile, Polyphase pp,
                bool aligned) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout<Sample>(pp, tile, kMode);
  float* os = smem + lay.out;
  const int tiles_a_row = (n_out + tile - 1) / tile;
  const int tiles = tiles_a_row * B;
  const long long total = static_cast<long long>(B) * T;

  if constexpr (kMode == kStaged) {
    const int ntab = pp.up * pp_stride(pp);
    for (int i = threadIdx.x; i < ntab; i += kThreads) smem[i] = table[i];
  }
  auto window = [&](int it) { return reinterpret_cast<Sample*>(smem + lay.win + (it & 1) * lay.wstride); };
  auto start = [&](int it, const Tile& tl) -> int {  // the copies of tl's window; its shift
    if constexpr (kMode == kGlobalAll) return 0;
    return pp_stage(window(it), x, total, static_cast<long long>(tl.b) * T, tl.lo,
                    pp_window(tl.n, pp), aligned);
  };

  int t = blockIdx.x;
  Tile cur = tile_of(min(t, tiles - 1), tiles_a_row, tile, n_out, pp);
  int shift = t < tiles ? start(0, cur) : 0;
  pp_copies_commit();
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    const int tn = t + gridDim.x;
    Tile next = tile_of(min(tn, tiles - 1), tiles_a_row, tile, n_out, pp);
    const int next_shift = tn < tiles ? start(it + 1, next) : 0;
    pp_copies_commit();
    pp_copies_wait<1>();  // the current tile's
    __syncthreads();      // the current window (and os, free since the last store) for everyone
    const long long len = row_length(lengths, cur.b, T);
    if (out_lengths && cur.j0 == 0 && threadIdx.x == 0) {
      const long long n = lengths ? lengths[cur.b] : T;
      out_lengths[cur.b] = static_cast<int>(min(pp_output_length(n, pp), 0x7FFFFFFFLL));
    }
    auto put = [=](int i, float v) { os[i] = v; };
    if constexpr (kMode == kGlobalAll) {
      const PpGlobalWindow<Sample> in{x + static_cast<size_t>(cur.b) * T, cur.lo, len};
      pp_block(cur.j0, cur.n, 0, cur.n, cur.lo, in, PpGlobalTaps{table}, pp, put);
    } else {
      Sample* in = window(it) + shift;
      if (pp_needs_mask(cur.lo, pp_window(cur.n, pp), len)) {  // a row's ends, or past its length
        pp_mask(in, cur.lo, pp_window(cur.n, pp), len);
        __syncthreads();
      }
      if constexpr (kMode == kStaged) {
        pp_block(cur.j0, cur.n, 0, cur.n, cur.lo, in, static_cast<const float*>(smem), pp, put);
      } else {
        pp_block(cur.j0, cur.n, 0, cur.n, cur.lo, in, PpGlobalTaps{table}, pp, put);
      }
    }
    __syncthreads();  // os complete; the window free for the tile after next
    float* out = y + static_cast<size_t>(cur.b) * n_out + cur.j0;
    for (int i = threadIdx.x; i < cur.n; i += kThreads) out[i] = os[i];
    cur = next;
    shift = next_shift;
  }
}

// The launch of one instantiation, or the card's view of it (info != null:
// registers, local bytes, blocks an SM, shared memory a block).
template <typename Sample, int kMode>
int run(const void* x, float* y, const float* table, const int* lengths, int* out_lengths, int B,
        int T, int n_out, int tile, const Polyphase& pp, cudaStream_t stream, int* info) {
  auto kernel = resample_kernel<Sample, kMode>;
  const int bytes = layout<Sample>(pp, tile, kMode).total * static_cast<int>(sizeof(float));
  if (bytes > kSmemBudget) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (info) {
    cudaFuncAttributes attr = {};
    err = cudaFuncGetAttributes(&attr, kernel);
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.localSizeBytes);
    info[2] = per_sm;
    info[3] = bytes;
    return err;
  }
  int sms = 0, dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((n_out + tile - 1) / tile) * B;
  const dim3 grid(static_cast<unsigned>(min(tiles, static_cast<long long>(max(per_sm, 1)) * sms)));
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  kernel<<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(
      static_cast<const Sample*>(x), y, table, lengths, out_lengths, B, T, n_out, tile, pp, aligned);
  return cudaGetLastError();
}

int dispatch(const void* x, int is_int16, float* y, const float* table, const int* lengths,
             int* out_lengths, int B, int T, int n_out, int tile, int mode, const Polyphase& pp,
             cudaStream_t stream, int* info) {
  if (B < 1 || T < 1 || n_out < 1 || pp.up < 1 || pp.down < 1 || pp.K < 1 ||
      tile < kTileStep || tile > kTileOut || tile % kTileStep != 0 || mode < kStaged ||
      mode > kGlobalAll || static_cast<long long>((n_out + tile - 1) / tile) * B > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
#define MFCC_RESAMPLE_RUN(S, M) run<S, M>(x, y, table, lengths, out_lengths, B, T, n_out, tile, pp, stream, info)
  if (is_int16) {
    return mode == kStaged ? MFCC_RESAMPLE_RUN(int16_t, kStaged)
         : mode == kGlobalTaps ? MFCC_RESAMPLE_RUN(int16_t, kGlobalTaps)
                               : MFCC_RESAMPLE_RUN(int16_t, kGlobalAll);
  }
  return mode == kStaged ? MFCC_RESAMPLE_RUN(float, kStaged)
       : mode == kGlobalTaps ? MFCC_RESAMPLE_RUN(float, kGlobalTaps)
                             : MFCC_RESAMPLE_RUN(float, kGlobalAll);
#undef MFCC_RESAMPLE_RUN
}

}  // namespace

extern "C" {

// Launches the resampler on `stream`; returns cudaGetLastError() (0 = launched).
// x [B, T] int16 (is_int16 != 0) or float32; y [B, n_out] float32; table
// [up, pp_stride] float32 (kernels/resample.py device_table); lengths [B]
// int32 or null (every row T samples long); out_lengths [B] int32 or null:
// ceil(lengths[b] * up / down) (of T without lengths), at most 2^31 - 1;
// tile outputs a tile and mode 0 / 1 / 2 (kernels/resample.py plan).
int mfcc_resample(const void* x, int is_int16, float* y, const float* table, const int* lengths,
                  int* out_lengths, int B, int T, int n_out, int up, int down, int half_len, int K,
                  int tile, int mode, void* stream) {
  return dispatch(x, is_int16, y, table, lengths, out_lengths, B, T, n_out, tile, mode,
                  Polyphase{up, down, half_len, K}, static_cast<cudaStream_t>(stream), nullptr);
}

// Registers, local (spilled) bytes a thread, blocks an SM and shared
// memory a block of the instantiation for these rows, ratio and plan, into
// out[0..4).
int mfcc_resample_kernel_info(int is_int16, int up, int down, int half_len, int K, int tile,
                              int mode, int* out) {
  return dispatch(nullptr, is_int16, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, tile, mode,
                  Polyphase{up, down, half_len, K}, nullptr, out);
}

const char* mfcc_resample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
