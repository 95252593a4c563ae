// Strict local-maximum peak scores for channel-last confidence maps.
//
// Replaces the Pallas TPU kernel sleap_nn_tpu/ops/pallas_kernels.py
// (_nms_scores_kernel, launched by nms_scores_pallas). For cms (B, H, W, C)
// it writes out[b, y, x, c] = cms[b, y, x, c] where that value is strictly
// greater than every other value of its k x k neighbourhood (cells outside
// the map count as -inf) and greater than the threshold, and -inf
// elsewhere. Comparisons are in f32; out is f32. A NaN neighbour makes the
// centre no peak, as jnp.maximum's NaN propagation does.
//
// What bounds it on an H100: bytes. It reads the map once (2 or 4 bytes
// an element) and writes 4 bytes an element, with a few comparisons in
// between: far below the card's 295 FLOP/B ridge.
//
// What the design does about it: one thread per output element, with
// channel-last offsets computed directly (no transposes, no padded copy).
// Consecutive threads touch consecutive elements, so each warp's centre
// reads and its writes are coalesced; the k*k - 1 neighbour reads of a
// warp hit the same few rows, which stay in L1 / L2, so device memory
// sees close to one read of the input and one write of the output.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) nms_scores_kernel(
    const T* __restrict__ cms, float* __restrict__ out, int64_t total, int H, int W,
    int C, int r, float threshold) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  const int x = (int)((i / C) % W);
  const int y = (int)((i / ((int64_t)C * W)) % H);
  const int64_t plane = i - (((int64_t)y * W + x) * C + c);  // offset of (b, 0, 0, 0)
  const float v = sleap::to_f32<T>(cms[i]);
  float nbr = -INFINITY;
  bool nan = false;
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -r; dx <= r; ++dx) {
      const int xx = x + dx;
      if ((dy == 0 && dx == 0) || xx < 0 || xx >= W) continue;
      const float s = sleap::to_f32<T>(cms[plane + ((int64_t)yy * W + xx) * C + c]);
      nan |= isnan(s);
      nbr = fmaxf(nbr, s);
    }
  }
  out[i] = (!nan && v > nbr && v > threshold) ? v : -INFINITY;
}

}  // namespace

// cms: (B, H, W, C) contiguous, bf16 (is_bf16=1) or f32; out: same shape,
// f32. kernel is odd and >= 3. Returns a cudaError_t.
extern "C" int nms_scores(const void* cms, float* out, int B, int H, int W, int C,
                          int kernel, float threshold, int is_bf16, void* stream) {
  const int64_t total = (int64_t)B * H * W * C;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  auto s = static_cast<cudaStream_t>(stream);
  const int r = kernel / 2;
  if (is_bf16)
    nms_scores_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(cms), out, total, H, W, C, r, threshold);
  else
    nms_scores_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(cms), out, total, H, W, C, r, threshold);
  return cudaGetLastError();
}

extern "C" const char* nms_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
