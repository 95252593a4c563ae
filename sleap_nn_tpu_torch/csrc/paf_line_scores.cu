// PAF line-integral scores of every candidate pair of every edge.
//
// Replaces the Pallas TPU kernel sleap_nn_tpu/ops/pallas_kernels.py
// (_paf_sample_kernel, launched by paf_line_samples_pallas), fused with the
// XLA code around it in sleap_nn_tpu/inference/paf_grouping.py
// (score_paf_lines_dense): line points, nearest-pixel subscripts, the PAF
// samples, the dot with the unit displacement, the mean over the line and
// the distance penalty. For each (b, e, i, j), with src = peaks[b, s_e, i],
// dst = peaks[b, d_e, j] and disp = dst - src:
//
//   out = mean_p(paf[b, y_p, x_p, 2e:2e+2] . disp / max(|disp|, 1e-8))
//         + w * min(max_edge_length / max(|disp|, 1e-8) - 1, 0)
//
// where (x_p, y_p) = clamp(rint((src + t_p * disp) / stride)), the line
// point rounded once (the fused multiply-add XLA emits under jit), the
// division IEEE, rint half-to-even as jnp.round, and the clamp after the
// int conversion. A pair whose endpoint is masked or has a non-finite x
// gets -inf and loads nothing. The TPU kernel's one-hot MXU matmul was a
// workaround for gathers; here each sample is a direct load.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// scattered loads. Each pair reads P pixels of its edge's two channels;
// the two channels sit next to each other in channel-last memory, so one
// 4-byte (bf16) or 8-byte (f32) load fetches both. The PAF map of the
// smoke configuration (8 x 256 x 256 x 28 bf16, 29 MB) fits in the 50 MB
// L2, so the loads mostly hit L2.
//
// What the design does about it: one thread per (b, e, i, j), j fastest,
// so a warp shares its source peak and walks lines that start at the same
// point; no shared memory. Staging the lines' pixels in shared memory and
// a fused per-edge top-K are later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// The (x, y) channel pair at p, as f32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) paf_line_scores_kernel(
    const T* __restrict__ pafs, const float* __restrict__ peaks,
    const uint8_t* __restrict__ mask, const int* __restrict__ edge_inds,
    const float* __restrict__ t, float* __restrict__ out, int64_t total, int Hp, int Wp,
    int N, int K, int E, int P, float stride, float max_edge_length,
    float dist_penalty_weight) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int dj = (int)(i % K);
  const int si = (int)((i / K) % K);
  const int e = (int)((i / ((int64_t)K * K)) % E);
  const int b = (int)(i / ((int64_t)K * K * E));
  const int sn = edge_inds[2 * e], dn = edge_inds[2 * e + 1];
  if (sn < 0 || sn >= N || dn < 0 || dn >= N) {
    out[i] = NAN;  // no such node: the wrapper's caller passed a bad edge
    return;
  }
  const int64_t s_at = ((int64_t)b * N + sn) * K + si;
  const int64_t d_at = ((int64_t)b * N + dn) * K + dj;
  const float sx = peaks[2 * s_at], sy = peaks[2 * s_at + 1];
  const float dx = peaks[2 * d_at], dy = peaks[2 * d_at + 1];
  if (!(mask[s_at] && mask[d_at] && isfinite(sx) && isfinite(dx))) {
    out[i] = -INFINITY;
    return;
  }
  if (!isfinite(sy) || !isfinite(dy)) {
    out[i] = NAN;  // the reference's arithmetic gives NaN here
    return;
  }
  const float vx = dx - sx, vy = dy - sy;
  const float len = sqrtf(vx * vx + vy * vy);
  const float safe_len = fmaxf(len, 1e-8f);
  const float ux = vx / safe_len, uy = vy / safe_len;
  const int C = 2 * E;
  const T* plane = pafs + (int64_t)b * Hp * Wp * C + 2 * e;
  float sum = 0.f;
  for (int p = 0; p < P; ++p) {
    const float tp = t[p];
    int x = __float2int_rn(__fdiv_rn(__fmaf_rn(tp, vx, sx), stride));
    int y = __float2int_rn(__fdiv_rn(__fmaf_rn(tp, vy, sy), stride));
    x = min(max(x, 0), Wp - 1);
    y = min(max(y, 0), Hp - 1);
    const float2 v = load_pair(plane + ((int64_t)y * Wp + x) * C);
    sum += v.x * ux + v.y * uy;
  }
  const float mean = sum / (float)P;
  const float penalty = fminf(max_edge_length / safe_len - 1.f, 0.f);
  out[i] = mean + penalty * dist_penalty_weight;
}

}  // namespace

// pafs: (B, Hp, Wp, 2E) contiguous, bf16 (is_bf16=1) or f32, aligned to a
// channel pair; peaks: (B, N, K, 2) f32; mask: (B, N, K) bool; edge_inds:
// (E, 2) int32; t: (P,) f32; out: (B, E, K, K) f32. Returns a cudaError_t.
extern "C" int paf_line_scores(const void* pafs, const float* peaks, const uint8_t* mask,
                               const int* edge_inds, const float* t, float* out, int B,
                               int Hp, int Wp, int N, int K, int E, int P, int is_bf16,
                               float stride, float max_edge_length,
                               float dist_penalty_weight, void* stream) {
  const int64_t total = (int64_t)B * E * K * K;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    paf_line_scores_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(pafs), peaks, mask, edge_inds, t, out, total, Hp,
        Wp, N, K, E, P, stride, max_edge_length, dist_penalty_weight);
  else
    paf_line_scores_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(pafs), peaks, mask, edge_inds, t, out, total, Hp, Wp, N,
        K, E, P, stride, max_edge_length, dist_penalty_weight);
  return cudaGetLastError();
}

extern "C" const char* paf_line_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
