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
// every other block by operations. This first version runs on the CUDA
// cores in f32 (67 TFLOP/s of peak, against 989 for bf16 tensor cores),
// so it is far from that bound; tensor cores (mma / wgmma), TMA and
// pipelining are later work.
//
// What the design does about the bound it can reach: the mid tensor never
// goes to device memory. One block owns an 8 x 16 output tile of one
// image: it stages the 12 x 20 input halo in shared memory a chunk of 16
// channels at a time, accumulates the 10 x 18 x Cmid mid tile in shared
// memory (f32), finishes it (bias, act, zero outside the image, round),
// then computes conv2 from shared memory into registers and writes only
// the output. Each thread keeps a 4-pixel x 4-channel register tile, so a
// float4 weight load and 4 shared loads feed 16 FMAs. Weights arrive from
// the wrapper as f32, (9, C, C_out padded to 4), read through the
// read-only cache; consecutive threads share a weight vector (broadcast)
// and read consecutive pixels (conflict-free shared loads).
#include <stdint.h>

#include "common.cuh"

namespace {

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
constexpr size_t MAX_SMEM = 227 * 1024;

size_t smem_bytes(int c_mid) {
  return sizeof(float) * ((size_t)c_mid * MPIX + (size_t)CK * IPIX);
}

__device__ __forceinline__ void fma4(float (&acc)[CG], float v, const float4& w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_double_conv3x3_kernel(
    const T* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ y,
    int H, int W, int c_in, int c_mid, int c_out, int c_mid_pad, int c_out_pad,
    int relu, int tiles_w) {
  extern __shared__ float smem[];
  float* mid = smem;                      // [c_mid][MPIX], f32
  float* xin = smem + (size_t)c_mid * MPIX;  // [CK][IPIX], f32

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const T* xb = x + (size_t)b * H * W * c_in;

  // conv1 over the mid tile, input channels in chunks of CK.
  const int m_items = MSLOTS * ((c_mid + CG - 1) / CG);
  for (int c0 = 0; c0 < c_in; c0 += CK) {
    const int ck = min(CK, c_in - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < ck * IPIX; i += THREADS) {
      const int c = i % ck, p = i / ck;
      const int gy = oy0 - 2 + p / IW, gx = ox0 - 2 + p % IW;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = sleap::to_f32<T>(xb[((size_t)gy * W + gx) * c_in + c0 + c]);
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

  // Finish the mid tile: bias, act, zeros outside the image, round to T.
  for (int i = tid; i < c_mid * MPIX; i += THREADS) {
    const int cm = i / MPIX, p = i % MPIX;
    const int gy = oy0 - 1 + p / MW, gx = ox0 - 1 + p % MW;
    float v = mid[i] + b1[cm];
    if (relu) v = sleap::relu_nan(v);
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) v = 0.f;
    mid[i] = sleap::round_to<T>(v);
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
      T* out = y + (((size_t)b * H + oy) * W + ox) * c_out;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        if (co + j >= c_out) continue;
        float v = acc[k][j] + b2[co + j];
        if (relu) v = sleap::relu_nan(v);
        out[co + j] = sleap::from_f32<T>(v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w1, const float* b1, const float* w2,
                   const float* b2, void* y, int B, int H, int W, int c_in, int c_mid,
                   int c_out, int c_mid_pad, int c_out_pad, int relu, cudaStream_t stream) {
  const size_t smem = smem_bytes(c_mid);
  if (smem > MAX_SMEM || B > 65535) return cudaErrorInvalidConfiguration;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  auto kernel = fused_double_conv3x3_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles_h * tiles_w, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, static_cast<T*>(y), H, W, c_in, c_mid,
      c_out, c_mid_pad, c_out_pad, relu, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, H, W, C) contiguous, bf16 (is_bf16=1) or f32. w1: (9, c_in,
// c_mid_pad) f32, w2: (9, c_mid, c_out_pad) f32, pads are multiples of 4
// and zero-filled; b1: (c_mid) f32, b2: (c_out) f32. Returns a cudaError_t.
extern "C" int fused_double_conv3x3(const void* x, const float* w1, const float* b1,
                                    const float* w2, const float* b2, void* y, int B,
                                    int H, int W, int c_in, int c_mid, int c_out,
                                    int c_mid_pad, int c_out_pad, int relu, int is_bf16,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, y, B, H, W, c_in, c_mid, c_out,
                                 c_mid_pad, c_out_pad, relu, s);
  return launch<float>(x, w1, b1, w2, b2, y, B, H, W, c_in, c_mid, c_out, c_mid_pad,
                       c_out_pad, relu, s);
}

extern "C" const char* fused_double_conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
