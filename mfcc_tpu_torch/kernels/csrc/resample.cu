// Polyphase resampler for Hopper (sm_90a): float32 rows [B, T] at sr_in ->
// [B, n_out] at sr_out, n_out = ceil(T * up / down); scipy resample_poly
// with constant (zero) padding.
//
// Replaces mfcc_tpu/kernels/resample.py::resample_pallas (:104, kernel
// _make_kernel :79, pallas_call :128), which takes integer decimation only;
// this kernel takes every ratio whose tap table fits its shared memory, so
// the JAX package's two-dot XLA path for 44.1 kHz and 8 kHz needs no port
// of its own. Plain version and wrapper: mfcc_tpu_torch/kernels/resample.py
// (resample_reference, polyphase_resample).
//
// Bound at the main path's shapes (48 kHz -> 16 kHz, [64, 480,080] ->
// [64, 160,027]; H100 SXM peaks): bytes 122.9 MB in + 41.0 MB out = 164 MB
// -> 49 us at 3.35 TB/s; operations 91 FLOP per output (the 61 symmetric
// taps folded) = 0.93 GFLOP -> 14 us at 67 TFLOP/s fp32. Bytes bound it;
// chip_smoke.py computes the bound from each run's inputs.
//
// Design. Tiles of kTileOut = 1,792 outputs of a row; 256 threads a block,
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
// L2's). A tap table larger than the shared-memory budget is refused by
// the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

#include "polyphase.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileOut = kPpR1 * kThreads;  // outputs per block (kernels/resample.py TILE_OUT)

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Shared memory, in floats: the table [up][pp_stride], two windows
// (pp_stage_floats: room for the alignment shift), the output row.
struct Layout {
  int win, wstride, out, total;
};

__host__ __device__ inline Layout layout(const Polyphase& pp) {
  Layout l;
  l.win = align4(pp.up * pp_stride(pp));
  l.wstride = pp_stage_floats<float>(pp_window(kTileOut, pp));
  l.out = l.win + 2 * l.wstride;
  l.total = l.out + kTileOut;
  return l;
}

// Tile t of the grid: its row, first output and outputs.
struct Tile {
  int b, n;
  long long j0, lo;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_a_row, int n_out, const Polyphase& pp) {
  Tile tl;
  tl.b = t / tiles_a_row;
  tl.j0 = static_cast<long long>(t - tl.b * tiles_a_row) * kTileOut;
  tl.n = static_cast<int>(min(static_cast<long long>(kTileOut), n_out - tl.j0));
  tl.lo = pp_first_input(tl.j0, pp);
  return tl;
}

// Starts the copies of tile tl's window into dst; returns its shift.
__device__ __forceinline__ int start_window(float* dst, const float* x, long long total, int T,
                                            const Tile& tl, const Polyphase& pp, bool aligned) {
  return pp_stage(dst, x, total, static_cast<long long>(tl.b) * T, tl.lo, pp_window(tl.n, pp),
                  aligned);
}

// Persistent: block k takes tiles k, k + grid, ...; the next tile's window
// copies run while the FIR computes the current one (two window buffers).
__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ table, int B, int T, int n_out, Polyphase pp,
                bool aligned) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(pp);
  float* tab = smem;
  float* os = smem + lay.out;
  const int tiles_a_row = (n_out + kTileOut - 1) / kTileOut;
  const int tiles = tiles_a_row * B;
  const long long total = static_cast<long long>(B) * T;

  const int ntab = pp.up * pp_stride(pp);
  for (int i = threadIdx.x; i < ntab; i += kThreads) tab[i] = table[i];

  int t = blockIdx.x;
  Tile cur = tile_of(min(t, tiles - 1), tiles_a_row, n_out, pp);
  int shift = t < tiles ? start_window(smem + lay.win, x, total, T, cur, pp, aligned) : 0;
  pp_copies_commit();
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    float* win = smem + lay.win + (it & 1) * lay.wstride;
    const int tn = t + gridDim.x;
    Tile next = tile_of(min(tn, tiles - 1), tiles_a_row, n_out, pp);
    int next_shift = 0;
    if (tn < tiles) {
      next_shift = start_window(smem + lay.win + ((it + 1) & 1) * lay.wstride, x, total, T, next,
                                pp, aligned);
    }
    pp_copies_commit();
    pp_copies_wait<1>();  // the current tile's
    __syncthreads();      // the current window (and os, free since the last store) for everyone
    if (pp_needs_mask(cur.lo, pp_window(cur.n, pp), T)) {  // a row's first or last tile
      pp_mask(win + shift, cur.lo, pp_window(cur.n, pp), T);
      __syncthreads();
    }
    pp_block(cur.j0, cur.n, 0, cur.n, cur.lo, win + shift, tab, pp,
             [=](int i, float v) { os[i] = v; });
    __syncthreads();  // os complete; the window free for the tile after next
    float* out = y + static_cast<size_t>(cur.b) * n_out + cur.j0;
    for (int i = threadIdx.x; i < cur.n; i += kThreads) out[i] = os[i];
    cur = next;
    shift = next_shift;
  }
}

}  // namespace

extern "C" {

// Launches the resampler on `stream`; returns cudaGetLastError() (0 = launched).
// x [B, T] float32; y [B, n_out] float32; table [up, pp_stride] float32
// (kernels/resample.py device_table).
int mfcc_resample(const float* x, float* y, const float* table, int B, int T, int n_out,
                  int up, int down, int half_len, int K, void* stream) {
  if (B < 1 || T < 1 || n_out < 1 || up < 1 || down < 1 || K < 1 ||
      static_cast<long long>((n_out + kTileOut - 1) / kTileOut) * B > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  const Polyphase pp{up, down, half_len, K};
  const int bytes = layout(pp).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0, dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resample_kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((n_out + kTileOut - 1) / kTileOut) * B;
  const dim3 grid(static_cast<unsigned>(min(tiles, static_cast<long long>(max(per_sm, 1)) * sms)));
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  resample_kernel<<<grid, kThreads, static_cast<size_t>(bytes),
                    static_cast<cudaStream_t>(stream)>>>(x, y, table, B, T, n_out, pp, aligned);
  return cudaGetLastError();
}

// Registers, local (spilled) bytes a thread, blocks an SM and shared
// memory a block of the kernel for this ratio, into out[0..4).
int mfcc_resample_kernel_info(int up, int down, int half_len, int K, int* out) {
  const Polyphase pp{up, down, half_len, K};
  const int bytes = layout(pp).total * static_cast<int>(sizeof(float));
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, resample_kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], resample_kernel, kThreads, bytes);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[3] = bytes;
  return err;
}

const char* mfcc_resample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
