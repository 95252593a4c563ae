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
// gets -inf and loads nothing; a non-finite y gives NaN, as the
// reference's arithmetic does. The output
// stays the dense (B, E, K, K) matrix: the host's Hungarian match uses the
// pairs below min_line_scores too. The TPU kernel's one-hot MXU matmul was
// a workaround for gathers; here each sample is a direct load.
//
// What bounds it on an H100: the latency of the scattered loads and the
// launch. Each pair reads P pixels of its edge's two channels, which sit
// next to each other in channel-last memory, so one 4-byte (bf16) or
// 8-byte (f32) load fetches both. The PAF map of the smoke configuration
// (8 x 256 x 256 x 28 bf16, 29 MB) fits in the 50 MB L2.
//
// What the design does about it: one block per (b, e) (blockIdx.y, x),
// its K x K pairs over the block's threads (K^2 rounded up to a warp, at
// most 512: one pass at the smoke's K = 20). The block stages the edge's K
// source and K destination peaks, their usability flags and t in shared
// memory once. Each pair issues its P loads before it reduces them: the
// load loop is unrolled over a compile-time chunk of 16 points (P above 16
// loops over chunks) and keeps each channel pair as the loaded word until
// the chunk's last load is issued, so the loads are in flight together.
// Index math is 32-bit within an image.
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int CHUNK = 16;  // line points whose loads are issued together

// The (x, y) channel pair: loaded as one word, converted to f32 after
// every load of a chunk has been issued.
template <typename T> struct PairOf;
template <> struct PairOf<float> {
  using type = float2;
  static __device__ __forceinline__ float2 to_f32(float2 v) { return v; }
};
template <> struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_f32(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};

// Peak flags staged per slot.
constexpr uint8_t USABLE = 1;  // mask set and x finite
constexpr uint8_t BAD_Y = 2;   // y not finite

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) paf_line_scores_kernel(
    const T* __restrict__ pafs, const float* __restrict__ peaks,
    const uint8_t* __restrict__ mask, const int* __restrict__ edge_inds,
    const float* __restrict__ t, float* __restrict__ out, int Hp, int Wp, int N, int K, int P,
    float stride, float max_edge_length, float dist_penalty_weight) {
  extern __shared__ float2 smem[];
  float2* ends = smem;                                     // [2K]: K sources, then K destinations
  float* ts = reinterpret_cast<float*>(ends + 2 * K);      // [P]
  uint8_t* flags = reinterpret_cast<uint8_t*>(ts + P);     // [2K]
  const int e = blockIdx.x, b = blockIdx.y, E = gridDim.x;
  const int KK = K * K;
  float* o = out + ((int64_t)b * E + e) * KK;
  const int sn = edge_inds[2 * e], dn = edge_inds[2 * e + 1];
  if (sn < 0 || sn >= N || dn < 0 || dn >= N) {
    for (int q = threadIdx.x; q < KK; q += blockDim.x)
      o[q] = NAN;  // no such node: the wrapper's caller passed a bad edge
    return;
  }
  for (int k = threadIdx.x; k < 2 * K; k += blockDim.x) {
    const int at = (b * N + (k < K ? sn : dn)) * K + (k < K ? k : k - K);
    const float2 p = reinterpret_cast<const float2*>(peaks)[at];
    ends[k] = p;
    flags[k] = (mask[at] && isfinite(p.x) ? USABLE : 0) | (isfinite(p.y) ? 0 : BAD_Y);
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) ts[p] = t[p];
  __syncthreads();

  const int C = 2 * E;
  const T* plane = pafs + (int64_t)b * Hp * Wp * C + 2 * e;
  for (int q = threadIdx.x; q < KK; q += blockDim.x) {
    const int i = q / K, j = q - i * K;
    const int fs = flags[i], fd = flags[K + j];
    if (!(fs & fd & USABLE)) {
      o[q] = -INFINITY;
      continue;
    }
    if ((fs | fd) & BAD_Y) {
      o[q] = NAN;
      continue;
    }
    const float2 s = ends[i], d = ends[K + j];
    const float vx = d.x - s.x, vy = d.y - s.y;
    const float len = sqrtf(vx * vx + vy * vy);
    const float safe_len = fmaxf(len, 1e-8f);
    const float ux = vx / safe_len, uy = vy / safe_len;
    float sum = 0.f;
    for (int p0 = 0; p0 < P; p0 += CHUNK) {
      typename PairOf<T>::type raw[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (p0 + u < P) {
          const float tp = ts[p0 + u];
          const float lx = __fmaf_rn(tp, vx, s.x), ly = __fmaf_rn(tp, vy, s.y);
          int x = __float2int_rn(__fdiv_rn(lx, stride));
          int y = __float2int_rn(__fdiv_rn(ly, stride));
          x = min(max(x, 0), Wp - 1);
          y = min(max(y, 0), Hp - 1);
          raw[u] = *reinterpret_cast<const typename PairOf<T>::type*>(plane + (y * Wp + x) * C);
        }
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (p0 + u < P) {
          const float2 v = PairOf<T>::to_f32(raw[u]);
          sum += v.x * ux + v.y * uy;
        }
      }
    }
    const float mean = sum / (float)P;
    const float penalty = fminf(max_edge_length / safe_len - 1.f, 0.f);
    o[q] = mean + penalty * dist_penalty_weight;
  }
}

// One call's arguments, as the C entry received them.
struct Call {
  const void* pafs;
  const float* peaks;
  const uint8_t* mask;
  const int* edge_inds;
  const float* t;
  float* out;
  int B, Hp, Wp, N, K, E, P;
  float stride, max_edge_length, dist_penalty_weight;
  size_t smem;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Call& c) {
  auto kernel = paf_line_scores_kernel<T>;
  if (c.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (err != cudaSuccess) return err;
  }
  // One pass over the K x K pairs where they fit in a block.
  const int threads = (int)std::min<int64_t>(MAX_THREADS, ((int64_t)c.K * c.K + 31) / 32 * 32);
  kernel<<<dim3((unsigned)c.E, (unsigned)c.B), threads, c.smem, c.stream>>>(
      static_cast<const T*>(c.pafs), c.peaks, c.mask, c.edge_inds, c.t, c.out, c.Hp, c.Wp, c.N,
      c.K, c.P, c.stride, c.max_edge_length, c.dist_penalty_weight);
  return cudaGetLastError();
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
  if ((int64_t)B * E * K * K == 0) return cudaSuccess;
  if (B > 65535 || P < 0 || (int64_t)K * K > 0x7fffffff ||
      (int64_t)B * N * K > 0x7fffffff || (int64_t)Hp * Wp * 2 * E > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * K * sizeof(float2) + (size_t)P * sizeof(float) + 2 * K;
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  const Call c{pafs, peaks, mask, edge_inds, t, out, B, Hp, Wp, N, K, E, P, stride,
               max_edge_length, dist_penalty_weight, smem, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch<__nv_bfloat16>(c) : launch<float>(c);
}

extern "C" const char* paf_line_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
