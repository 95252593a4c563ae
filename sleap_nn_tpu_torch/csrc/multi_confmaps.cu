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
// What bounds it on an H100: the output bytes plus the live terms. Every
// output element is written once (4 bytes). A Gaussian term is computed
// only where its point can reach the element's tile: expf(-x) is exactly
// 0 in f32 for x above about 103.97 (the last denormal), so at the
// training sigmas a point reaches a few dozen grid pixels around itself, a
// few percent of a 512 x 512 plane. At the bottom-up training shape
// (4, 6, 15, 2) -> (4, 512, 512, 15) the output is 62.9 MB, 18.8 us at
// 3.35 TB/s; at the centroid shape (one node) 4.19 MB, so the launch
// dominates there.
//
// What the design does about it: one block owns one output tile of one
// image, th x tw pixels (tw a power of two, both at most 32; the wrapper
// picks them from N) and all N nodes. The block
//  1. reduces the tile's own xv and yv values to a box (min and max, NaN
//     ignored; the grid vectors need not be sorted);
//  2. culls: for each node one warp ballots over the instances and compacts
//     the live points into a shared-memory list. A NaN point is dropped (its
//     terms are NaN, i.e. 0); so is a point whose smallest d^2 / denom over
//     the box exceeds `cutoff` (110, far above 103.97), since all its terms
//     in the tile are exactly 0. A non-finite bound keeps the point;
//  3. if any point is live, zeroes the tile in shared memory and computes
//     each live term there with the arithmetic above. A dropped term is an
//     exact 0, which cannot change a max that starts at 0, so the output is
//     the same, bit for bit, as computing every term;
//  4. stores each tile row, one contiguous span of the channel-last output,
//     with 16-byte stores where the span is aligned and scalar stores at its
//     ragged ends (N = 15 and odd widths give unaligned spans). A tile with
//     no live point stores zeros and never touches the shared tile.
// Instances are culled in chunks of `ich` per node, so the list stays small
// whatever I is. Index math within an image is 32-bit; row bases are 64-bit.
// Given a `stats` pointer (null on the training path), the blocks count what
// the cull kept: the tiles with a live point and the terms computed.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) multi_confmaps_kernel(
    const float* __restrict__ points, const float* __restrict__ xv,
    const float* __restrict__ yv, float* __restrict__ out, int I, int N, int H, int W,
    int tw_log2, int th, int ich, float denom, float cutoff,
    unsigned long long* __restrict__ stats) {
  extern __shared__ float4 smem[];
  const int tw = 1 << tw_log2;
  const int tile_len = (th * tw * N + 3) & ~3;  // floats, a whole number of float4
  float* tile = reinterpret_cast<float*>(smem);
  float2* list = reinterpret_cast<float2*>(tile + tile_len);  // [N][ich] live points
  int* count = reinterpret_cast<int*>(list + ich * N);        // [N] live points per node
  float* xs = reinterpret_cast<float*>(count + N);            // [tw] the tile's xv
  float* ys = xs + tw;                                        // [th] the tile's yv
  float* box = ys + th;                                       // x min, x max, y min, y max

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = blockIdx.x << tw_log2, y0 = blockIdx.y * th, b = blockIdx.z;
  const int nx = min(tw, W - x0), ny = min(th, H - y0);

  // The first chunk's point of this lane (node `warp`, instance `lane`),
  // loaded before the box is known so that its latency overlaps the grid's.
  const float* pts = points + (int64_t)b * I * N * 2;
  float px0 = NAN, py0 = NAN;
  if (warp < N && lane < min(I, ich)) {
    px0 = pts[(lane * N + warp) * 2];
    py0 = pts[(lane * N + warp) * 2 + 1];
  }

  // 1. The tile's grid values and their box: warp 0 takes x, warp 1 y.
  if (warp < 2) {
    const int n = warp == 0 ? nx : ny;
    const float g = lane < n ? (warp == 0 ? xv[x0 + lane] : yv[y0 + lane]) : NAN;
    if (lane < n) (warp == 0 ? xs : ys)[lane] = g;
    float lo = isnan(g) ? INFINITY : g, hi = isnan(g) ? -INFINITY : g;
    for (int o = 16; o; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
    }
    if (lane == 0) {
      box[2 * warp] = lo;
      box[2 * warp + 1] = hi;
    }
  }
  __syncthreads();
  const float bx0 = box[0], bx1 = box[1], by0 = box[2], by1 = box[3];

  bool rendered = false;  // the same in every thread: the shared tile holds values
  for (int i0 = 0; i0 < I; i0 += ich) {
    const int i1 = min(I, i0 + ich);
    // 2. Cull: per node, one warp keeps the points that can reach the tile.
    bool found = false;
    for (int n = warp; n < N; n += WARPS) {
      int c = 0;
      for (int ib = i0; ib < i1; ib += 32) {
        const int i = ib + lane;
        float px = NAN, py = NAN;
        if (ib == 0 && n == warp) {  // the first chunk's first batch, loaded above
          px = px0;
          py = py0;
        } else if (i < i1) {
          px = pts[(i * N + n) * 2];
          py = pts[(i * N + n) * 2 + 1];
        }
        const float ex = fmaxf(fmaxf(bx0 - px, px - bx1), 0.f);
        const float ey = fmaxf(fmaxf(by0 - py, py - by1), 0.f);
        const float bound = (ex * ex + ey * ey) / denom;
        const bool live = !isnan(px) && !isnan(py) && !(isfinite(bound) && bound > cutoff);
        const unsigned m = __ballot_sync(FULL, live);
        if (live) list[n * ich + c + __popc(m & ((1u << lane) - 1u))] = make_float2(px, py);
        c += __popc(m);
      }
      if (lane == 0) {
        count[n] = c;
        if (stats != nullptr && c > 0) atomicAdd(&stats[1], (unsigned long long)c * nx * ny);
      }
      found |= c > 0;
    }
    if (!__syncthreads_or(found)) continue;

    // 3. Render the live terms into the shared tile.
    if (!rendered) {
      for (int k = threadIdx.x; k < tile_len / 4; k += THREADS)
        smem[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      rendered = true;
    }
    for (int n = 0; n < N; ++n) {
      const int c = count[n];
      if (c == 0) continue;
      const float2* l = list + n * ich;
      for (int p = threadIdx.x; p < th * tw; p += THREADS) {
        const int r = p >> tw_log2, col = p & (tw - 1);
        if (r >= ny || col >= nx) continue;
        const float gx = xs[col], gy = ys[r];
        float m = tile[p * N + n];
        for (int k = 0; k < c; ++k) {
          const float dx = gx - l[k].x;
          const float dy = gy - l[k].y;
          float v = expf(-(dx * dx + dy * dy) / denom);
          if (isnan(v)) v = 0.f;
          m = fmaxf(m, v);
        }
        tile[p * N + n] = m;
      }
    }
    __syncthreads();  // before the next chunk rewrites the lists, and before the stores
  }
  if (stats != nullptr && rendered && threadIdx.x == 0) atomicAdd(&stats[0], 1ull);

  // 4. Store: row r of the tile is out[b, y0 + r, x0 : x0 + nx, :], nx * N floats.
  const int span = nx * N;
  for (int r = warp; r < ny; r += WARPS) {
    float* dst = out + (((int64_t)b * H + y0 + r) * W + x0) * N;
    const float* src = tile + r * tw * N;
    const int head = min(span, (int)((0u - (unsigned)(reinterpret_cast<uintptr_t>(dst) >> 2)) & 3u));
    const int body = (span - head) >> 2;  // float4 stores
    const int items = span - 3 * body;    // head + body + tail
    for (int k = lane; k < items; k += 32) {
      if (k >= head && k < head + body) {
        const int at = head + 4 * (k - head);
        const float4 v = rendered ? make_float4(src[at], src[at + 1], src[at + 2], src[at + 3])
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dst + at) = v;
      } else {
        const int at = k < head ? k : k + 3 * body;
        dst[at] = rendered ? src[at] : 0.f;
      }
    }
  }
}

}  // namespace

// points: (B, I, N, 2) f32 contiguous; xv: (W,) f32; yv: (H,) f32;
// out: (B, H, W, N) f32 contiguous, 4-byte aligned. I >= 1. Tile: 2^tw_log2
// x th pixels (tw_log2 <= 5, 1 <= th <= 32); ich: instances culled at once
// (1 <= ich <= I). cutoff: the d^2 / denom above which a term is exactly 0.
// stats: null, or two zeroed counters the kernel adds to: the tiles that
// rendered a live point, and the terms computed (live points x pixels).
// Returns a cudaError_t.
extern "C" int multi_confmaps(const float* points, const float* xv, const float* yv,
                              float* out, int B, int I, int N, int H, int W, int tw_log2,
                              int th, int ich, float denom, float cutoff,
                              unsigned long long* stats, void* stream) {
  if ((int64_t)B * H * W * N == 0) return cudaSuccess;
  if (I < 1 || H > 65535 || B > 65535 || (int64_t)W * N > 0x7fffffff - THREADS ||
      (int64_t)I * N * 2 > 0x7fffffff || tw_log2 < 0 || tw_log2 > 5 || th < 1 || th > 32 ||
      ich < 1 || ich > I)
    return cudaErrorInvalidValue;
  const int tw = 1 << tw_log2;
  const size_t tile = (((size_t)th * tw * N + 3) & ~(size_t)3) * sizeof(float);
  const size_t smem = tile + (size_t)ich * N * sizeof(float2) + (size_t)N * sizeof(int) +
                      (size_t)(tw + th + 4) * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        multi_confmaps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((W + tw - 1) >> tw_log2), (unsigned)((H + th - 1) / th),
                  (unsigned)B);
  multi_confmaps_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      points, xv, yv, out, I, N, H, W, tw_log2, th, ich, denom, cutoff, stats);
  return cudaGetLastError();
}

extern "C" const char* multi_confmaps_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
