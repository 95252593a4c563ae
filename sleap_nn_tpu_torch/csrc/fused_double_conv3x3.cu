// Fused double 3x3 conv: y = act(conv3x3(act(conv3x3(x) + b1)) + b2).
//
// Replaces the Pallas TPU kernel sleap_nn_tpu/ops/fused_conv.py
// (_kernel, launched by _fused_tpu through fused_double_conv3x3). SAME
// padding, NHWC activations; act is relu or identity. Conv1's output (the
// "mid" tensor) is zeroed outside the image before conv2, as conv2's zero
// padding of a separately computed mid would see it, and rounded to the
// input type; accumulation, bias and activation are f32.
//
// What bounds it on an H100: in bf16 the UNet medium_rf blocks do from
// about 220 FLOP per byte that must move (enc0, 1 -> 24 -> 24 channels)
// to about 1,100 (dec0, 303 -> 121 -> 121). The card's ridge is 295
// FLOP/B (989 TFLOP/s over 3.35 TB/s), so enc0 is bound by bytes and
// every other block by operations: the tensor cores.
//
// bf16 (the predict path): an implicit GEMM on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate). One block of 8 warps owns
// a TH x TW output tile of one image, with every channel. The tile and one
// of two kernel variants come from the planner in ops/fused_conv.py, a cost
// model over tiles (large for narrow blocks, where the mid recompute
// (TH+2)(TW+2)/(TH TW) is the waste; small for wide blocks, to fit shared
// memory, and for small maps, to make blocks).
//  - The (TH+4) x (TW+4) input halo, every channel, is copied once into
//    shared memory as [pixel][channels padded to 8, row stride an odd
//    number of 16-byte units] (conflict-free ldmatrix), with 16-byte
//    loads of each halo row's aligned superset (one NHWC halo row is one
//    contiguous span, at any channel count), four in flight a thread,
//    repacked on the way. A UNet decoder block's input is concat(skip,
//    upsample2x(low)): given low, the kernel reads the skip into the first
//    channels and upsamples low into the rest as it builds the halo
//    (upsample_halo), so neither the upsampled map nor the concat is ever
//    written to device memory.
//  - conv1 is a GEMM with M = the (TH+2) x (TW+2) mid pixels, N = c_mid,
//    K = 9 taps x c_in in groups of 8 channels: a 16-deep k-step may take
//    its two halves from two taps, so K pads to 16 only once, not per tap.
//    A comes from the halo by ldmatrix: each lane gives one pixel's
//    16-byte channel group, and a tap is an address offset (a table of one
//    offset per K group; no im2col copy). c_in = 1 (enc0) folds the 9 taps
//    into one K of 16 instead, from a small im2col tile. B (weights) is
//    packed once by the wrapper into the mma fragment order, bf16,
//    zero-padded, and streamed from L2 through a 3-chunk cp.async ring in
//    shared memory, shared by the block's warps.
//  - The warps work in passes, in step: each owns 2 m16 tiles x the pass's
//    n8 tiles (a compile-time count: no mma on padding) and keeps their
//    accumulators in registers over the whole K. The conv1 epilogue adds
//    b1, applies act, zeroes mid outside the image, rounds to bf16 and
//    writes the mid tile to shared memory (pad channels exactly 0) in the
//    layout conv2's ldmatrix reads. Mid never goes to device memory.
//  - conv2 is the same GEMM over the output tile, K = 9 x c_mid. Its
//    epilogue stages the bf16 tile in shared memory (over the dead halo)
//    and writes each output row span with 16-byte stores.
//  - Variants: <2 blocks an SM, passes of up to 6 n8 tiles> for narrow
//    blocks (latency hidden by the second block), <1, 8> for wide ones
//    (the registers of longer passes).
// f32: the CUDA-core kernel below (TF32 would break the f32 tolerance).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a block may take
constexpr int MAX_DEVICES = 64;      // devices whose shared-memory limit is tracked

// ---------------------------------------------------------------------------
// f32: CUDA cores, 8 x 16 output tile, halo staged 16 channels at a time,
// mid accumulated in shared memory (f32), 4-pixel x 4-channel register tiles.
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int TH = 8, TW = 16;           // output tile
constexpr int MH = TH + 2, MW = TW + 2;  // mid tile
constexpr int IH = TH + 4, IW = TW + 4;  // input halo tile
constexpr int MPIX = MH * MW, IPIX = IH * IW, OPIX = TH * TW;
constexpr int CK = 16;                   // input channels per staged chunk
constexpr int PX = 4;                    // pixels per thread
constexpr int CG = 4;                    // channels per thread
constexpr int THREADS = 256;
constexpr int MSLOTS = (MPIX + PX - 1) / PX;
constexpr int OSLOTS = OPIX / PX;

size_t smem_bytes(int c_mid) {
  return sizeof(float) * ((size_t)c_mid * MPIX + (size_t)CK * IPIX);
}

__device__ __forceinline__ void fma4(float (&acc)[CG], float v, const float4& w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

__global__ void __launch_bounds__(THREADS) kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ y,
    int H, int W, int c_in, int c_mid, int c_out, int c_mid_pad, int c_out_pad,
    int relu, int tiles_w) {
  extern __shared__ float smem[];
  float* mid = smem;                      // [c_mid][MPIX], f32
  float* xin = smem + (size_t)c_mid * MPIX;  // [CK][IPIX], f32

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const float* xb = x + (size_t)b * H * W * c_in;

  // conv1 over the mid tile, input channels in chunks of CK.
  const int m_items = MSLOTS * ((c_mid + CG - 1) / CG);
  for (int c0 = 0; c0 < c_in; c0 += CK) {
    const int ck = min(CK, c_in - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < ck * IPIX; i += THREADS) {
      const int c = i % ck, p = i / ck;
      const int gy = oy0 - 2 + p / IW, gx = ox0 - 2 + p % IW;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[((size_t)gy * W + gx) * c_in + c0 + c];
      xin[c * IPIX + p] = v;
    }
    __syncthreads();
    for (int item = tid; item < m_items; item += THREADS) {
      const int slot = item % MSLOTS, co = (item / MSLOTS) * CG;
      int base[PX];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const int p = min(slot + k * MSLOTS, MPIX - 1);
        base[k] = (p / MW) * IW + p % MW;
      }
      float acc[PX][CG] = {};
      for (int c = 0; c < ck; ++c) {
        const float* xc = xin + c * IPIX;
        const float* wc = w1 + (size_t)(c0 + c) * c_mid_pad + co;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(
              wc + (size_t)t * c_in * c_mid_pad));
          const int off = (t / 3) * IW + t % 3;
#pragma unroll
          for (int k = 0; k < PX; ++k) fma4(acc[k], xc[base[k] + off], wv);
        }
      }
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const int p = slot + k * MSLOTS;
        if (p >= MPIX) continue;
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          if (co + j >= c_mid) continue;
          float* m = mid + (size_t)(co + j) * MPIX + p;
          *m = (c0 == 0) ? acc[k][j] : *m + acc[k][j];
        }
      }
    }
  }
  __syncthreads();

  // Finish the mid tile: bias, act, zeros outside the image.
  for (int i = tid; i < c_mid * MPIX; i += THREADS) {
    const int cm = i / MPIX, p = i % MPIX;
    const int gy = oy0 - 1 + p / MW, gx = ox0 - 1 + p % MW;
    float v = mid[i] + b1[cm];
    if (relu) v = sleap::relu_nan(v);
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) v = 0.f;
    mid[i] = v;
  }
  __syncthreads();

  // conv2 from shared memory; only the output goes to device memory.
  const int o_items = OSLOTS * ((c_out + CG - 1) / CG);
  for (int item = tid; item < o_items; item += THREADS) {
    const int slot = item % OSLOTS, co = (item / OSLOTS) * CG;
    int base[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const int p = slot + k * OSLOTS;
      base[k] = (p / TW) * MW + p % TW;
    }
    float acc[PX][CG] = {};
    for (int cm = 0; cm < c_mid; ++cm) {
      const float* mc = mid + (size_t)cm * MPIX;
      const float* wc = w2 + (size_t)cm * c_out_pad + co;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(
            wc + (size_t)t * c_mid * c_out_pad));
        const int off = (t / 3) * MW + t % 3;
#pragma unroll
        for (int k = 0; k < PX; ++k) fma4(acc[k], mc[base[k] + off], wv);
      }
    }
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const int p = slot + k * OSLOTS;
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy >= H || ox >= W) continue;
      float* out = y + (((size_t)b * H + oy) * W + ox) * c_out;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        if (co + j >= c_out) continue;
        float v = acc[k][j] + b2[co + j];
        if (relu) v = sleap::relu_nan(v);
        out[co + j] = v;
      }
    }
  }
}

cudaError_t launch(const void* x, const void* w1, const float* b1, const void* w2,
                   const float* b2, void* y, int B, int H, int W, int c_in, int c_mid,
                   int c_out, int relu, cudaStream_t stream) {
  const size_t smem = smem_bytes(c_mid);
  if (smem > MAX_SMEM || B > 65535) return cudaErrorInvalidConfiguration;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles_h * tiles_w, B), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(y), H, W, c_in, c_mid, c_out,
      (c_mid + 3) / 4 * 4, (c_out + 3) / 4 * 4, relu, tiles_w);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (see the note at the top).
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int WM = 2;  // m16 tiles of a warp in one pass
constexpr int WN = 8;  // n8 tiles of one pass, at most (the wide variant's)
constexpr int KC = 4;   // k-steps of one staged weight chunk
constexpr int NST = 3;  // chunks in the weight ring: NST - 1 in flight while one is used
constexpr int WBUF = NST * KC * WN * 32 * 8;  // bytes of the weight ring

// 16-byte units of one pixel row in shared memory for c channels: the
// channels padded to 8, then to an odd count of units, so the 8 rows of an
// ldmatrix (consecutive pixels) fall in 8 different bank groups.
__host__ __device__ inline int row_units(int c) {
  const int g = (c + 7) / 8;
  return g | 1;
}

struct Layout {  // byte offsets in dynamic shared memory
  int ktab, wbuf, mid, src, total;
};

__host__ __device__ inline int k_groups(int c_in, int taps9) {  // 8-channel K groups of a conv
  return taps9 ? 9 * ((c_in + 7) / 8) : 2;
}

// Must equal ops/fused_conv.py::smem_bytes: a zero row, the K-group
// offset table, the weight ring, the mid tile, then the conv1 source
// shared with the staged output tile.
__host__ __device__ inline Layout layout(int th, int tw, int c_in, int c_mid, int c_out) {
  const int mpix = (th + 2) * (tw + 2);
  const int g1 = k_groups(c_in, c_in > 1), g2 = k_groups(c_mid, 1);
  const int ktab = ((g1 > g2 ? g1 : g2) + 1) / 2 * 8;  // 2 ints a k-step
  const int ktab16 = (ktab + 15) / 16 * 16;
  const int mid = mpix * row_units(c_mid) * 16;
  const int halo = (th + 4) * (tw + 4) * row_units(c_in) * 16;
  const int src = c_in == 1 ? mpix * 3 * 16 + halo : halo;  // c_in = 1: im2col tile, then halo
  const int out = th * tw * c_out * 2;
  const int big = ((src > out ? src : out) + 15) / 16 * 16;
  const int wbuf = 16 + ktab16;
  return {16, wbuf, wbuf + WBUF, wbuf + WBUF + mid, wbuf + WBUF + mid + big};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most NST - 2 of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The A operand of one conv: pixel rows in shared memory.
struct Src {
  unsigned base;  // shared address of pixel 0
  int units;      // row stride, 16-byte units
  int sw;         // width of the source pixel grid
  int cg;         // 8-channel groups per tap
  int taps;       // 9 (3x3 shifts) or 1 (rows already im2col'd)
};

// One pass of a conv GEMM (see conv_gemm): this warp's WM m16 tiles from
// t0 on, NN n8 tiles from n0 on, accumulators in registers over the whole
// K, the weights streamed through the ring.
template <int NN, typename Epi>
__device__ __forceinline__ void gemm_pass(const Src& s, const uint2* __restrict__ w,
                                          int n_tiles, int n0, int t0, int M, int ow,
                                          int ksteps, const int* ktab, unsigned zero,
                                          uint2* wbuf, const Epi& epi) {
  const int lane = threadIdx.x % 32, khalf = lane >> 4;
  const bool active = t0 * 16 < M;
  const int chunks = (ksteps + KC - 1) / KC;
  const unsigned wring = smem_addr(wbuf);
  // Stage chunk c into ring slot c % NST (an empty copy group past the
  // last chunk keeps the waits uniform).
  auto stage = [&](int c) {
    const int k0 = c * KC, kn = c < chunks ? min(KC, ksteps - k0) : 0;
    for (int u = threadIdx.x; u < kn * NN * 16; u += THREADS) {
      const int q = u & 15, j = (u >> 4) % NN, kk = (u >> 4) / NN;
      cp_async16(wring + (unsigned)((((c % NST) * KC + kk) * NN + j) * 256 + q * 16),
                 w + ((size_t)(k0 + kk) * n_tiles + n0 + j) * 32 + q * 2);
    }
    cp_async_commit();
  };
  unsigned abase[WM];  // this lane's ldmatrix row: its pixel's first channel group
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    const int m = min((t0 + i) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, M - 1);
    abase[i] = s.base + (unsigned)(((m / ow) * s.sw + m % ow) * s.units * 16);
  }
  float acc[WM][NN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  for (int c = 0; c < NST - 1; ++c) stage(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_ring();
    // Chunk c is in the ring for every warp, and every warp is done with
    // chunk c - 1, whose slot the next stage reuses.
    __syncthreads();
    stage(c + NST - 1);
    if (!active) continue;
    const uint2* wc = wbuf + (c % NST) * KC * NN * 32 + lane;
    const int kn = min(KC, ksteps - c * KC);
    for (int kk = 0; kk < kn; ++kk) {
      const int off = ktab[2 * (c * KC + kk) + khalf];
      unsigned a[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i) ldmatrix_x4(a[i], off >= 0 ? abase[i] + off : zero);
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const uint2 b = wc[(kk * NN + j) * 32];
#pragma unroll
        for (int i = 0; i < WM; ++i) mma_bf16(acc[i][j], a[i], b);
      }
    }
  }
  __syncthreads();  // the ring is free for the next pass
  if (!active) return;
  float2 bias[NN];  // this lane's two channels of each n8 tile, loaded together
#pragma unroll
  for (int j = 0; j < NN; ++j) bias[j] = epi.bias((n0 + j) * 8 + (lane & 3) * 2);
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (t0 + i) * 16 + (lane >> 2) + 8 * h;
      if (m >= M) continue;
      const auto row = epi.row(m);
#pragma unroll
      for (int j = 0; j < NN; ++j)
        epi.put(row, (n0 + j) * 8 + (lane & 3) * 2, acc[i][j][2 * h] + bias[j].x,
                acc[i][j][2 * h + 1] + bias[j].y);
    }
  }
}

// out[m, n] = sum_k A[m, k] W[k, n] over the oh x ow output pixel grid.
// Output pixel (m / ow, m % ow) reads source pixel
// (m / ow + di) * sw + m % ow + dj for tap (di, dj). K runs over
// (tap, 8-channel group) pairs, two a k-step, each pair's shared-memory
// offset from the table ktab (-1 past the last group: the zero row). w:
// the weights in fragment order, (ksteps, n_tiles, 32 lanes) x 4 bf16.
// epi.row(m) prepares output pixel m; epi.put(row, n, v0, v1) takes its
// channels n, n + 1.
//
// The block works in passes, all warps in step: a pass covers WARPS x WM
// m16 tiles (WM a warp) and up to WNMAX n8 tiles, a compile-time count, so
// no mma slot is spent on padding. The pass's weights stream through a ring
// of NST chunks of KC k-steps in shared memory (cp.async, NST - 1 chunks
// in flight while the tensor cores work on one), so each weight is read
// from L2 once a pass for the whole block, not once a warp.
template <int WNMAX, typename Epi>
__device__ __forceinline__ void conv_gemm(const Src s, const uint2* __restrict__ w,
                                          int n_tiles, int oh, int ow, unsigned zero,
                                          uint2* wbuf, int* ktab, const Epi& epi) {
  const int M = oh * ow;
  const int groups = s.taps * s.cg, ksteps = (groups + 1) / 2;
  for (int g = threadIdx.x; g < 2 * ksteps; g += THREADS) {
    int off = -1;
    if (g < groups) {
      const int tap = g / s.cg, cgi = g - tap * s.cg;
      const int shift = s.taps == 9 ? (tap / 3) * s.sw + tap % 3 : 0;
      off = (shift * s.units + cgi) * 16;
    }
    ktab[g] = off;
  }
  __syncthreads();
  const int mt = (M + 15) / 16, mp = (mt + WARPS * WM - 1) / (WARPS * WM);
  const int nc = (n_tiles + WNMAX - 1) / WNMAX, wn = (n_tiles + nc - 1) / nc;
  const int warp = threadIdx.x / 32;
  for (int pass = 0; pass < mp * nc; ++pass) {
    const int n0 = (pass / mp) * wn, nn = min(wn, n_tiles - n0);
    const int t0 = ((pass % mp) * WARPS + warp) * WM;  // this warp's first m16 tile
#define FDC_PASS(NN) \
  case NN: gemm_pass<NN>(s, w, n_tiles, n0, t0, M, ow, ksteps, ktab, zero, wbuf, epi); break;
    switch (nn) {
      FDC_PASS(1) FDC_PASS(2) FDC_PASS(3) FDC_PASS(4)
      FDC_PASS(5) FDC_PASS(6)
    }
    if constexpr (WNMAX > 6) {
      switch (nn) { FDC_PASS(7) FDC_PASS(8) }
    }
#undef FDC_PASS
  }
}

// conv1's epilogue: act, 0 outside the image, bf16 into the mid tile (the
// bias, padded to 8 with zeros, is added by gemm_pass).
struct MidEpi {
  bf16* mid;
  const float* b1;
  int units, mw, oy0, ox0, H, W, relu;
  struct Row {
    bf16* p;
    bool inside;
  };
  __device__ __forceinline__ Row row(int m) const {
    const int my = m / mw, mx = m - my * mw;
    const int gy = oy0 - 1 + my, gx = ox0 - 1 + mx;
    return {mid + (size_t)m * units * 8, gy >= 0 && gy < H && gx >= 0 && gx < W};
  }
  __device__ __forceinline__ float2 bias(int n) const {
    return __ldg(reinterpret_cast<const float2*>(b1 + n));
  }
  __device__ __forceinline__ void put(const Row& r, int n, float v0, float v1) const {
    if (relu) {
      v0 = sleap::relu_nan(v0);
      v1 = sleap::relu_nan(v1);
    }
    if (!r.inside) v0 = v1 = 0.f;
    *reinterpret_cast<__nv_bfloat162*>(r.p + n) = __floats2bfloat162_rn(v0, v1);
  }
};

// conv2's epilogue: act, bf16, staged compact ([row][valid cols][c_out]).
struct OutEpi {
  bf16* st;
  const float* b2;
  int tw, vw, vh, c_out, relu;
  struct Row {
    bf16* p;
    bool valid;
  };
  __device__ __forceinline__ Row row(int m) const {
    const int py = m / tw, px = m - py * tw;
    return {st + ((size_t)py * vw + px) * c_out, py < vh && px < vw};
  }
  __device__ __forceinline__ float2 bias(int n) const {
    return __ldg(reinterpret_cast<const float2*>(b2 + n));
  }
  __device__ __forceinline__ void put(const Row& r, int n, float v0, float v1) const {
    if (!r.valid) return;
    if (n < c_out) r.p[n] = __float2bfloat16_rn(relu ? sleap::relu_nan(v0) : v0);
    if (n + 1 < c_out) r.p[n + 1] = __float2bfloat16_rn(relu ? sleap::relu_nan(v1) : v1);
  }
};

// Reads `rows` spans of an NHWC tensor x (numel elements, c channels), row
// r the len elements from start(r) on (start(r) < 0: no such row), as each
// span's 16-byte-aligned superset with 16-byte loads, four in flight a
// thread, and hands each element to put(r, pixel of the span, channel, bits).
template <typename Start, typename Put>
__device__ __forceinline__ void load_spans(const bf16* __restrict__ x, int64_t numel, int rows,
                                           int len, int c, const Start& start, const Put& put) {
  const int nck = len / 8 + 2;
  constexpr int U = 4;  // 16-byte loads in flight per thread
  for (int i0 = threadIdx.x; i0 < rows * nck; i0 += U * THREADS) {
    uint4 raw[U];
    int64_t at[U], st[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      const int r = i / nck, k = i - r * nck;
      st[u] = i < rows * nck ? start(r) : -1;
      at[u] = (st[u] & ~(int64_t)7) + 8 * k;
      if (st[u] < 0 || at[u] >= st[u] + len) {
        at[u] = -1;  // nothing of a span in this chunk
      } else if (at[u] + 8 <= numel) {
        raw[u] = __ldg(reinterpret_cast<const uint4*>(x + at[u]));
      } else {
        unsigned short e[8];
        for (int j = 0; j < 8; ++j)
          e[j] = at[u] + j < numel ? __bfloat16_as_ushort(x[at[u] + j]) : (unsigned short)0;
        raw[u] = make_uint4(e[0] | ((unsigned)e[1] << 16), e[2] | ((unsigned)e[3] << 16),
                            e[4] | ((unsigned)e[5] << 16), e[6] | ((unsigned)e[7] << 16));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (at[u] < 0) continue;
      const int64_t a = at[u], s = st[u];
      const int r = (i0 + u * THREADS) / nck;
      const unsigned words[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      const int j0 = (int)(a < s ? s - a : 0);
      const int first = (int)(a + j0 - s);
      int px = first / c, ch = first - px * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= j0 && a + j < s + len) {
          put(r, px, ch, (unsigned short)(words[j / 2] >> (16 * (j % 2))));
          if (++ch == c) {
            ch = 0;
            ++px;
          }
        }
      }
    }
  }
}

// The input halo of the tile, [pixel][units * 8] bf16, channels [0, c_x)
// from x (channels past those and pixels outside the image stay 0). Each
// in-image halo row is one contiguous NHWC span.
__device__ __forceinline__ void load_halo(const bf16* __restrict__ x, int64_t numel, bf16* halo,
                                          int units, int b, int H, int W, int c_x, int oy0,
                                          int ox0, int ih, int iw) {
  const int gx0 = max(0, ox0 - 2), gx1 = min(W, ox0 - 2 + iw);
  const int px0 = gx0 - (ox0 - 2);
  unsigned short* h = reinterpret_cast<unsigned short*>(halo);
  load_spans(
      x, numel, ih, (gx1 - gx0) * c_x, c_x,
      [&](int r) {
        const int gy = oy0 - 2 + r;
        return gy < 0 || gy >= H ? (int64_t)-1 : ((int64_t)(b * H + gy) * W + gx0) * c_x;
      },
      [&](int r, int px, int c, unsigned short v) { h[(r * iw + px0 + px) * units * 8 + c] = v; });
}

// Channels [c_s, c_s + c_l) of the halo: the bilinear 2x upsampling of low,
// (B, H/2, W/2, c_l) NHWC, with half-pixel centres (F.interpolate with
// align_corners=False, jax.image.resize): output row 2k + 1 takes 0.75 of
// source row k and 0.25 of k + 1, row 2k 0.25 of k - 1 and 0.75 of k, the
// source index clamped to the map; columns alike. The tile's low-resolution
// footprint, about (th/2 + 4) x (tw/2 + 4) pixels, is read from device
// memory once, with the halo's 16-byte span loads, and staged in shared
// memory over the weight ring and the mid tile (both unused until conv1) as
// [8-channel group][row][col] 16-byte units, as many groups a round as fit
// (the ring alone holds 1536 units, over three groups of the largest
// footprint, 20 x 20). Each in-image halo pixel then blends its 2 x 2
// parents, 8 channels a thread, in f32 in the order of terms of PyTorch's
// upsample_bilinear2d, and rounds once to bf16. Not inlined: inlined, it
// raised the <2, 6> kernel's spills and cost the one-source form 3%.
__device__ __noinline__ void upsample_halo(const bf16* __restrict__ low, bf16* halo,
                                              unsigned char* stage, int stage_bytes, int units,
                                              int b, int H, int W, int c_s, int c_l, int oy0,
                                              int ox0, int ih, int iw) {
  const int hl = H >> 1, wl = W >> 1;
  const int64_t numel = (int64_t)gridDim.y * hl * wl * c_l;
  const int gy0 = max(0, oy0 - 2), gy1 = min(H, oy0 - 2 + ih);
  const int gx0 = max(0, ox0 - 2), gx1 = min(W, ox0 - 2 + iw);
  // The first source row of output row g is max(0, (g - 1) >> 1); the last
  // footprint row is the second source row of the last halo row.
  const int ly0 = max(0, (gy0 - 1) >> 1), lx0 = max(0, (gx0 - 1) >> 1);
  const int fh = min(max(0, (gy1 - 2) >> 1) + 1, hl - 1) - ly0 + 1;
  const int fw = min(max(0, (gx1 - 2) >> 1) + 1, wl - 1) - lx0 + 1;
  const int fpix = fh * fw, groups = (c_l + 7) / 8, gmax = stage_bytes / 16 / fpix;
  const int hw = gx1 - gx0, npix = (gy1 - gy0) * hw;
  const uint4* st = reinterpret_cast<const uint4*>(stage);
  unsigned short* st16 = reinterpret_cast<unsigned short*>(stage);
  unsigned short* h16 = reinterpret_cast<unsigned short*>(halo);
  for (int g0 = 0; g0 < groups; g0 += gmax) {
    const int gn = min(gmax, groups - g0);
    if (g0 > 0) __syncthreads();  // the previous round's readers are done
    load_spans(
        low, numel, fh, fw * c_l, c_l,
        [&](int r) { return ((int64_t)(b * hl + ly0 + r) * wl + lx0) * c_l; },
        [&](int r, int px, int c, unsigned short v) {
          const int g = (c >> 3) - g0;
          if (g >= 0 && g < gn) st16[((g * fh + r) * fw + px) * 8 + (c & 7)] = v;
        });
    __syncthreads();
    for (int i = threadIdx.x; i < gn * npix; i += THREADS) {
      const int g = i / npix, p = i - g * npix;
      const int gy = gy0 + p / hw, gx = gx0 + p % hw;
      const float ry = fmaxf(0.f, 0.5f * (gy + 0.5f) - 0.5f);
      const float rx = fmaxf(0.f, 0.5f * (gx + 0.5f) - 0.5f);
      const int y0 = (int)ry, x0 = (int)rx;
      const float h1 = ry - y0, h0 = 1.f - h1, w1 = rx - x0, w0 = 1.f - w1;
      const int y1 = y0 + (y0 < hl - 1), x1 = x0 + (x0 < wl - 1);
      const uint4* sg = st + g * fpix;
      const uint4 q[4] = {sg[(y0 - ly0) * fw + x0 - lx0], sg[(y0 - ly0) * fw + x1 - lx0],
                          sg[(y1 - ly0) * fw + x0 - lx0], sg[(y1 - ly0) * fw + x1 - lx0]};
      const int c0 = (g0 + g) * 8, n = min(8, c_l - c0);
      unsigned short* out =
          h16 + (size_t)((gy - (oy0 - 2)) * iw + gx - (ox0 - 2)) * units * 8 + c_s + c0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned word = (&q[j].x)[k / 2];
          v[j] = __uint_as_float(k % 2 ? word & 0xffff0000u : word << 16);
        }
        const float y = h0 * (w0 * v[0] + w1 * v[1]) + h1 * (w0 * v[2] + w1 * v[3]);
        if (k < n) out[k] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
      }
    }
  }
}

// MINB resident blocks an SM (registers capped to fit them), passes of up
// to WNMAX n8 tiles: <2, 6> keeps two blocks on an SM to hide latency;
// <1, 8> gives wide blocks the registers of longer passes.
template <int MINB, int WNMAX>
__global__ void __launch_bounds__(THREADS, MINB) kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ low, const uint2* __restrict__ w1,
    const float* __restrict__ b1, const uint2* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ y, int H, int W, int c_in, int c_skip, int c_mid, int c_out, int relu,
    int th, int tw, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(th, tw, c_in, c_mid, c_out);
  uint2* wbuf = reinterpret_cast<uint2*>(smem + lay.wbuf);
  bf16* mid = reinterpret_cast<bf16*>(smem + lay.mid);
  bf16* src = reinterpret_cast<bf16*>(smem + lay.src);
  const int tid = threadIdx.x, b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * th, ox0 = (blockIdx.x % tiles_w) * tw;
  const int mh = th + 2, mw = tw + 2, ih = th + 4, iw = tw + 4;
  const int mid_units = row_units(c_mid);
  const int c_x = low ? c_skip : c_in;  // channels of x
  const int64_t numel = (int64_t)gridDim.y * H * W * c_x;

  // Zero the zero row, and the conv1 source (pads and outside pixels).
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n_src = (c_in == 1 ? mh * mw * 3 : 0) + ih * iw * row_units(c_in);
    uint4* zs = reinterpret_cast<uint4*>(smem + lay.src);
    if (tid == 0) z[0] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < n_src; i += THREADS) zs[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  Src s1;
  if (c_in == 1) {
    // The halo (one 16-byte unit a pixel) after the im2col tile, then the
    // im2col of the mid tile from it: K = 9 taps (+ 7 zeros), rows of 3 units.
    const bf16* halo = src + mh * mw * 24;
    load_halo(x, numel, src + mh * mw * 24, 1, b, H, W, 1, oy0, ox0, ih, iw);
    __syncthreads();
    for (int p = tid; p < mh * mw; p += THREADS) {
      const int py = p / mw, px = p - py * mw;
#pragma unroll
      for (int t = 0; t < 9; ++t) src[p * 24 + t] = halo[((py + t / 3) * iw + px + t % 3) * 8];
    }
    s1 = {smem_addr(src), 3, mw, 2, 1};
  } else {
    load_halo(x, numel, src, row_units(c_in), b, H, W, c_x, oy0, ox0, ih, iw);
    if (low)  // the concat's second part, upsampled here: it never exists in device memory
      upsample_halo(low, src, smem + lay.wbuf, lay.src - lay.wbuf, row_units(c_in), b, H, W,
                    c_skip, c_in - c_skip, oy0, ox0, ih, iw);
    s1 = {smem_addr(src), row_units(c_in), iw, (c_in + 7) / 8, 9};
  }
  __syncthreads();

  // conv1 -> mid tile; conv2 -> output tile, staged over the halo.
  const unsigned zero = smem_addr(smem);
  int* ktab = reinterpret_cast<int*>(smem + lay.ktab);
  conv_gemm<WNMAX>(s1, w1, (c_mid + 7) / 8, mh, mw, zero, wbuf, ktab,
            MidEpi{mid, b1, mid_units, mw, oy0, ox0, H, W, relu});
  __syncthreads();
  const int vw = min(tw, W - ox0), vh = min(th, H - oy0);
  const Src s2 = {smem_addr(mid), mid_units, mw, (c_mid + 7) / 8, 9};
  conv_gemm<WNMAX>(s2, w2, (c_out + 7) / 8, th, tw, zero, wbuf, ktab,
            OutEpi{src, b2, tw, vw, vh, c_out, relu});
  __syncthreads();

  // Each output row span is contiguous in NHWC: 16-byte stores where aligned.
  const int len = vw * c_out, nck = len / 8 + 2;
  const unsigned short* st = reinterpret_cast<const unsigned short*>(src);
  unsigned short* yo = reinterpret_cast<unsigned short*>(y);
  for (int i = tid; i < vh * nck; i += THREADS) {
    const int r = i / nck, k = i - r * nck;
    const int64_t g0 = (((int64_t)b * H + oy0 + r) * W + ox0) * c_out;
    const int64_t a = (g0 & ~(int64_t)7) + 8 * k;
    if (a >= g0 + len) continue;
    const unsigned short* sr = st + (size_t)r * len;  // the row's staged span
    if (a >= g0 && a + 8 <= g0 + len) {
      const int e = (int)(a - g0);
      unsigned u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = sr[e + 2 * j] | ((unsigned)sr[e + 2 * j + 1] << 16);
      *reinterpret_cast<uint4*>(yo + a) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      for (int64_t e = max(a, g0); e < min(a + 8, g0 + len); ++e) yo[e] = sr[e - g0];
    }
  }
}

template <int MINB, int WNMAX>
cudaError_t launch(const void* x, const void* low, const void* w1, const float* b1,
                   const void* w2, const float* b2, void* y, int B, int H, int W, int c_in,
                   int c_skip, int c_mid, int c_out, int relu, int th, int tw,
                   cudaStream_t stream) {
  if (th < 1 || tw < 1 || B > 65535 || c_in < 1 || c_mid < 1 || c_out < 1)
    return cudaErrorInvalidValue;
  if (low && (c_skip < 1 || c_skip >= c_in || H % 2 || W % 2)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(low) % 16 || reinterpret_cast<uintptr_t>(w1) % 8 ||
      reinterpret_cast<uintptr_t>(w2) % 8)
    return cudaErrorMisalignedAddress;
  const Layout lay = layout(th, tw, c_in, c_mid, c_out);
  const size_t smem = lay.total;
  if (smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
  // upsample_halo stages at least one 8-channel group of the footprint a round.
  if (low && (th / 2 + 4) * (tw / 2 + 4) * 16 > lay.src - lay.wbuf)
    return cudaErrorInvalidConfiguration;
  // The limit belongs to the function on one device: raise it once a device
  // (the current one, which the wrapper sets to the tensors').
  static bool attr_set[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attr_set[device]) {
    err = cudaFuncSetAttribute(kernel<MINB, WNMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set[device] = true;
  }
  const int tiles_w = (W + tw - 1) / tw, tiles_h = (H + th - 1) / th;
  kernel<MINB, WNMAX><<<dim3(tiles_h * tiles_w, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(low),
      static_cast<const uint2*>(w1), b1, static_cast<const uint2*>(w2), b2,
      static_cast<bf16*>(y), H, W, c_in, c_skip, c_mid, c_out, relu, th, tw, tiles_w);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x, y: (B, H, W, C) contiguous, bf16 (is_bf16=1) or f32.
// bf16: w1, w2 in the mma fragment order of ops/fused_conv.py::pack_weight
// (bf16, 8-byte aligned); b1, b2 f32 padded with zeros to a multiple of 8;
// tile_h x tile_w output tile and the variant (blocks a SM: 2 or 1) from
// the planner; x and y 16-byte aligned. low: null, or (bf16 only) the
// input's second part, (B, H/2, W/2, c_in - c_skip) contiguous and 16-byte
// aligned, upsampled 2x (bilinear) into channels [c_skip, c_in) as it is
// read; x then holds channels [0, c_skip).
// f32: w1 (9, c_in, c_mid padded to 4), w2 (9, c_mid, c_out padded to 4)
// f32, zero-filled; b1 (c_mid), b2 (c_out) f32; the tile is fixed (8 x 16).
// Returns a cudaError_t.
extern "C" int fused_double_conv3x3(const void* x, const void* low, const void* w1,
                                    const float* b1, const void* w2, const float* b2, void* y,
                                    int B, int H, int W, int c_in, int c_skip, int c_mid,
                                    int c_out, int relu, int is_bf16, int tile_h, int tile_w,
                                    int blocks_per_sm, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && blocks_per_sm == 2)
    return tc::launch<2, 6>(x, low, w1, b1, w2, b2, y, B, H, W, c_in, c_skip, c_mid, c_out,
                            relu, tile_h, tile_w, s);
  if (is_bf16 && blocks_per_sm == 1)
    return tc::launch<1, 8>(x, low, w1, b1, w2, b2, y, B, H, W, c_in, c_skip, c_mid, c_out,
                            relu, tile_h, tile_w, s);
  if (is_bf16 || low) return cudaErrorInvalidValue;
  return f32::launch(x, w1, b1, w2, b2, y, B, H, W, c_in, c_mid, c_out, relu, s);
}

extern "C" const char* fused_double_conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
