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
// What the design does about it: a 2-D grid, blockIdx.x over spans of
// SPAN elements of the contiguous W * C row and blockIdx.y over bands of
// ROWS rows of one image. A block stages its band's rows plus r above and
// below, each over its span and r * C elements more on either side, into
// shared memory as f32 with 16-byte loads of the aligned superset; what
// lies outside the map stays -inf. So the map is read about
// (ROWS + 2r) / ROWS times, not k times. In the row, the neighbour dx of
// element e is e + dx * C, and it falls outside [0, W * C) exactly when
// x + dx falls outside [0, W): no per-element division at all, and 32-bit
// index math throughout. Each thread takes V positions THREADS apart
// (consecutive lanes read consecutive shared words: no bank conflicts)
// and walks down the band's column: it reads each staged row once per
// position, keeps the row maxima over dx in registers, and writes ROWS
// outputs per position, each warp 128 contiguous bytes at a time. Maxima
// propagate NaN (jnp.maximum), so a NaN neighbour makes the centre no
// peak.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256, V = 4, SPAN = THREADS * V;
constexpr int ROWS = 8;  // output rows of a band
constexpr int MAX_RAD = 4;  // kernel sizes up to 9

// max that propagates NaN, as jnp.maximum does.
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

template <typename T, int RAD>
__global__ void __launch_bounds__(THREADS) nms_scores_kernel(
    const T* __restrict__ cms, float* __restrict__ out, int B, int H, int WC, int C,
    float threshold) {
  extern __shared__ float tile[];  // [ROWS + 2 RAD][width]
  constexpr int VE = 16 / sizeof(T);  // elements of one 16-byte load
  constexpr int NR = ROWS + 2 * RAD;  // staged rows
  const int halo = RAD * C, width = SPAN + 2 * halo;
  const int s0 = blockIdx.x * SPAN;  // first output of the span, in its row
  const int lo = max(s0 - halo, 0), hi = min(s0 + SPAN + halo, WC);
  const int numel = B * H * WC;
  const int nck = (hi - lo) / VE + 2;  // 16-byte chunks that cover [lo, hi)
  const int bands = (H + ROWS - 1) / ROWS;
  const int tid = threadIdx.x;
  for (int band = blockIdx.y; band < B * bands; band += gridDim.y) {
    const int b = band / bands, y0 = (band - b * bands) * ROWS;
    __syncthreads();  // the previous band's readers are done
    for (int i = tid; i < NR * width; i += THREADS) tile[i] = -INFINITY;
    __syncthreads();
    for (int i = tid; i < NR * nck; i += THREADS) {
      const int dy = i / nck, q = i - dy * nck;
      const int yy = y0 - RAD + dy;
      if (yy < 0 || yy >= H) continue;
      const int g = (b * H + yy) * WC;  // the staged row's first element
      const int a = ((g + lo) & ~(VE - 1)) + q * VE;
      if (a >= g + hi) continue;
      __align__(16) T v[VE];
      if (a + VE <= numel) {
        *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(cms + a));
      } else {
#pragma unroll
        for (int j = 0; j < VE; ++j) v[j] = cms[min(a + j, numel - 1)];
      }
      float* t = tile + dy * width + halo - s0;  // t[e] holds row element e
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        const int e = a + j - g;
        if (e >= lo && e < hi) t[e] = sleap::to_f32<T>(v[j]);
      }
    }
    __syncthreads();
    const int nrows = min(ROWS, H - y0);
    for (int j = 0; j < V; ++j) {
      const int p = tid + j * THREADS;  // position in the span
      if (s0 + p >= WC) break;
      const float* col = tile + halo + p;
      float full[NR], side[NR];  // per staged row: max over dx, and over dx != 0
#pragma unroll
      for (int yy = 0; yy < NR; ++yy) {
        float m = -INFINITY;
#pragma unroll
        for (int dx = 1; dx <= RAD; ++dx)
          m = nan_max(m, nan_max(col[yy * width - dx * C], col[yy * width + dx * C]));
        side[yy] = m;
        full[yy] = nan_max(m, col[yy * width]);
      }
      float* o = out + (b * H + y0) * WC + s0 + p;
#pragma unroll
      for (int ry = 0; ry < ROWS; ++ry) {
        if (ry >= nrows) break;
        float nbr = side[ry + RAD];
#pragma unroll
        for (int dy = 1; dy <= RAD; ++dy)
          nbr = nan_max(nbr, nan_max(full[ry + RAD - dy], full[ry + RAD + dy]));
        const float v = col[(ry + RAD) * width];
        o[ry * WC] = (v > nbr && v > threshold) ? v : -INFINITY;
      }
    }
  }
}

template <typename T, int RAD>
cudaError_t launch(const void* cms, float* out, int B, int H, int WC, int C, float threshold,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * (ROWS + 2 * RAD) * (SPAN + 2 * (size_t)RAD * C);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_scores_kernel<T, RAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int bands = B * ((H + ROWS - 1) / ROWS);
  const dim3 grid((WC + SPAN - 1) / SPAN, bands < 65535 ? bands : 65535);
  nms_scores_kernel<T, RAD><<<grid, THREADS, smem, s>>>(static_cast<const T*>(cms), out, B, H,
                                                        WC, C, threshold);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rad(const void* cms, float* out, int B, int H, int WC, int C, int r,
                       float threshold, cudaStream_t s) {
  switch (r) {
    case 1: return launch<T, 1>(cms, out, B, H, WC, C, threshold, s);
    case 2: return launch<T, 2>(cms, out, B, H, WC, C, threshold, s);
    case 3: return launch<T, 3>(cms, out, B, H, WC, C, threshold, s);
    case 4: return launch<T, 4>(cms, out, B, H, WC, C, threshold, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// cms: (B, H, W, C) contiguous and 16-byte aligned, bf16 (is_bf16=1) or
// f32, fewer than 2^31 elements; out: same shape, f32. kernel is odd, 3 to
// 9. Returns a cudaError_t.
extern "C" int nms_scores(const void* cms, float* out, int B, int H, int W, int C,
                          int kernel, float threshold, int is_bf16, void* stream) {
  const int64_t total = (int64_t)B * H * W * C;
  if (total == 0) return cudaSuccess;
  if (total >= ((int64_t)1 << 31) - 16 || kernel < 3 || kernel > 2 * MAX_RAD + 1 || kernel % 2 == 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(cms) % 16) return cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_rad<__nv_bfloat16>(cms, out, B, H, W * C, C, kernel / 2, threshold, s);
  return launch_rad<float>(cms, out, B, H, W * C, C, kernel / 2, threshold, s);
}

extern "C" const char* nms_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
