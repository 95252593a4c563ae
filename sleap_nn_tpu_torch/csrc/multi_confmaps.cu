// Multi-instance Gaussian confidence maps (training targets).
//
// Replaces the Pallas TPU kernel sleap_nn_tpu/ops/pallas_kernels.py
// (_confmap_kernel, launched by make_multi_confmaps_pallas). For points
// (B, I, N, 2) (x, y), NaN-padded, and grid vectors xv (W,), yv (H,), it
// writes out[b, y, x, n] = max over i of
//     expf(-((xv[x] - px)^2 + (yv[y] - py)^2) / denom),  denom = f32(2 sigma^2),
// each term that is NaN (a NaN instance or node) set to 0 before the max.
// The numerics follow the JAX package's default (jnp) path, not the Pallas
// body: an IEEE division by denom (not a multiplication by its reciprocal)
// and expf (no fast-math intrinsics, no --use_fast_math).
//
// What bounds it on an H100: bytes. Each output element is written once
// (4 bytes) after I * ~10 operations on values held in registers; the
// inputs (B*I*N*2 + H + W floats) are a few kilobytes. At the centroid
// training shape (4, 6, 1, 2) -> (4, 512, 512, 1) it writes 4.19 MB, about
// 1.25 us at 3.35 TB/s, so in practice the launch latency dominates.
//
// What the design does about it: one thread per output element, with the
// node index fastest, so the threads of a warp write consecutive addresses
// (channel-last, coalesced). A 2-D grid (row-within-image x, then y and b
// from blockIdx.y / blockIdx.z) keeps the index math in 32 bits. The I
// points of (b, n) are read from global memory: the warp's threads read
// the same few points, which stay in L1. The running max lives in a
// register; nothing is staged in shared memory.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) multi_confmaps_kernel(
    const float* __restrict__ points, const float* __restrict__ xv,
    const float* __restrict__ yv, float* __restrict__ out, int I, int N, int H, int W,
    float denom) {
  const int j = blockIdx.x * THREADS + threadIdx.x;  // (x, n) within the row
  if (j >= W * N) return;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int n = j % N;
  const int x = j / N;
  const float gx = xv[x];
  const float gy = yv[y];
  const float* p = points + ((int64_t)b * I * N + n) * 2;
  float m = 0.f;  // every term is >= 0 once NaN is zeroed, and I >= 1
  for (int i = 0; i < I; ++i) {
    const float dx = gx - p[(int64_t)i * N * 2];
    const float dy = gy - p[(int64_t)i * N * 2 + 1];
    float v = expf(-(dx * dx + dy * dy) / denom);
    if (isnan(v)) v = 0.f;
    m = fmaxf(m, v);
  }
  out[((int64_t)b * H + y) * W * N + j] = m;
}

}  // namespace

// points: (B, I, N, 2) f32 contiguous; xv: (W,) f32; yv: (H,) f32;
// out: (B, H, W, N) f32 contiguous. I >= 1. Returns a cudaError_t.
extern "C" int multi_confmaps(const float* points, const float* xv, const float* yv,
                              float* out, int B, int I, int N, int H, int W, float denom,
                              void* stream) {
  if ((int64_t)B * H * W * N == 0) return cudaSuccess;
  if (I < 1 || H > 65535 || B > 65535 || (int64_t)W * N > 0x7fffffff - THREADS)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((W * N + THREADS - 1) / THREADS), (unsigned)H, (unsigned)B);
  multi_confmaps_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      points, xv, yv, out, I, N, H, W, denom);
  return cudaGetLastError();
}

extern "C" const char* multi_confmaps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
