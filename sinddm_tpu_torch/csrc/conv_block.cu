// The SinDDM conv block on Hopper, NHWC, fp32 accumulation:
//
//   h1  = dw5x5(x) + bdw + cond[b]                 zero outside the image
//   g   = gelu(conv3x3(h1, W1) + b1)               zero outside the image
//   out = conv3x3(g, W2) + b2 + (x @ Wres + bres | x)
//
// Replaces the TPU kernel sinddm_tpu/ops/pallas_conv.py `_conv_block_kernel`
// (entry `fused_conv_block`). That kernel was shaped by VMEM, 128-lane DMA
// and the MXU; this one is written for the SM's registers and shared memory.
//
// What bounds it on the H100: operations. At the finest balloons shape
// (16x186x248) the 160->160 block is 686 GFLOP against 0.94 GB of input
// plus output, ~730 FLOP per byte. The products run as fp32 fmaf on the
// SIMT cores (67 TFLOP/s on the SXM part; the TF32 tensor cores would
// give 495), so the design keeps the FMA pipes busy:
//   * implicit GEMM: a block owns an 8x16-pixel x 80-channel output tile of
//     one image and walks the input channels in chunks of 8, staging the
//     (8+2)x(16+2) halo tile and the 3x3x8x80 weight slab in shared memory;
//   * each of the 160 threads keeps an 8-pixel x 8-channel register tile
//     (64 accumulators). Per input channel and kernel row it reads 10 input
//     values once and reuses them for the 3 horizontal taps, and reads its
//     8 weights as two 16-byte loads, so a shared-memory load feeds ~12 FMAs;
//   * ragged H, W (W = 64, 90, 126, 177, 248) and small channel counts
//     (l1's C = 3) are masked while staging; no channel padding.
// Zero padding: the split below stores h1 and g only inside the image, and
// every 3x3 stage reads zeros outside it, so each stage sees zero padding,
// never bias+cond or gelu(b1) (the `valid1`/`valid2` masks of the TPU kernel).
//
// Three launches per block: h1 (dw+bias+cond) is the kernel of dw_conv.cu;
// this file holds conv1+bias+GELU and conv2+bias+residual. The split costs
// two extra device-memory round trips, h1 and g each written once and read
// once: 2*B*H*W*(C+Co)*sizeof(T) bytes, 1.89 GB for the fp32 160->160 block
// at the finest shape (0.56 ms at 3.35 TB/s), beside tens of ms of FMA work.
// A fused wgmma/TMA kernel is later work.
//
// Types: T = float, or __nv_bfloat16 with fp32 accumulation. In bf16 the
// intermediates h1 and g are rounded to bf16 before each product, as the TPU
// kernel rounds them to the input type; bf16 x bf16 products are exact in fp32.
//
// C interface, loaded with ctypes: every entry returns the first non-zero
// cudaError_t of its launches (0 on success) and never synchronises.
#include "common.cuh"

namespace sinddm {

constexpr int kTH = 8;                               // output rows per block
constexpr int kTW = 16;                              // output cols per block
constexpr int kTN = 80;                              // output channels per block
constexpr int kPX = 8;                               // output cols per thread
constexpr int kCO = 8;                               // output channels per thread
constexpr int kKC = 8;                               // input channels per chunk
constexpr int kColThreads = kTW / kPX;               // 2
constexpr int kPixThreads = kTH * kColThreads;       // 16
constexpr int kCoThreads = kTN / kCO;                // 10
constexpr int kThreads = kPixThreads * kCoThreads;   // 160
constexpr int kInH = kTH + 2;
constexpr int kInW = kTW + 2;

enum Epilogue { kGelu = 0, kIdentityRes = 1, kProjRes = 2 };

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// out = epilogue(conv3x3_same(in, w) + bias). For kProjRes the 1x1
// projection of `res` is accumulated into the same registers.
template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ in, int Cin,     // [B,H,W,Cin]
               const T* __restrict__ w,               // [3,3,Cin,Co]
               const T* __restrict__ bias,            // [Co]
               const T* __restrict__ res, int Cres,   // [B,H,W,Cres]
               const T* __restrict__ wres,            // [Cres,Co]  (kProjRes)
               const T* __restrict__ bres,            // [Co]       (kProjRes)
               T* __restrict__ out,                   // [B,H,W,Co]
               int H, int W, int Co, int tiles_w) {
  __shared__ float s_in[kKC][kInH][kInW];
  __shared__ __align__(16) float s_w[9][kKC][kTN];

  const int tid = threadIdx.x;
  const int cg = tid % kCoThreads;
  const int pt = tid / kCoThreads;
  const int r = pt / kColThreads;
  const int c0 = (pt % kColThreads) * kPX;

  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * kTN;
  const int b = blockIdx.z;

  float acc[kPX][kCO];
#pragma unroll
  for (int j = 0; j < kPX; ++j)
#pragma unroll
    for (int k = 0; k < kCO; ++k) acc[j][k] = 0.f;

  const T* in_b = in + (size_t)b * H * W * Cin;
  for (int k0 = 0; k0 < Cin; k0 += kKC) {
    for (int e = tid; e < kKC * kInH * kInW; e += kThreads) {
      const int ci = e % kKC;
      const int p = e / kKC;
      const int gy = y0 - 1 + p / kInW;
      const int gx = x0 - 1 + p % kInW;
      const int k = k0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && k < Cin)
        v = to_f32(in_b[((size_t)gy * W + gx) * Cin + k]);
      s_in[ci][p / kInW][p % kInW] = v;
    }
    for (int e = tid; e < 9 * kKC * kTN; e += kThreads) {
      const int n = e % kTN;
      const int q = e / kTN;
      const int ci = q % kKC;
      const int t = q / kKC;
      const int k = k0 + ci;
      const int co = n0 + n;
      float v = 0.f;
      if (k < Cin && co < Co) v = to_f32(w[((size_t)t * Cin + k) * Co + co]);
      s_w[t][ci][n] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < kKC; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[kPX + 2];
#pragma unroll
        for (int j = 0; j < kPX + 2; ++j) v[j] = s_in[ci][r + dy][c0 + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wa = *reinterpret_cast<const float4*>(&s_w[dy * 3 + dx][ci][cg * kCO]);
          const float4 wb = *reinterpret_cast<const float4*>(&s_w[dy * 3 + dx][ci][cg * kCO + 4]);
          const float wv[kCO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kPX; ++j)
#pragma unroll
            for (int k = 0; k < kCO; ++k) acc[j][k] = fmaf(v[j + dx], wv[k], acc[j][k]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (EPI == kProjRes) {
    // 1x1 projection of the block input: same register tile, no halo
    float(*s_x)[kTH][kTW] = reinterpret_cast<float(*)[kTH][kTW]>(&s_in[0][0][0]);
    float(*s_r)[kTN] = reinterpret_cast<float(*)[kTN]>(&s_w[0][0][0]);
    const T* res_b = res + (size_t)b * H * W * Cres;
    for (int k0 = 0; k0 < Cres; k0 += kKC) {
      for (int e = tid; e < kKC * kTH * kTW; e += kThreads) {
        const int ci = e % kKC;
        const int p = e / kKC;
        const int gy = y0 + p / kTW;
        const int gx = x0 + p % kTW;
        const int k = k0 + ci;
        float v = 0.f;
        if (gy < H && gx < W && k < Cres) v = to_f32(res_b[((size_t)gy * W + gx) * Cres + k]);
        s_x[ci][p / kTW][p % kTW] = v;
      }
      for (int e = tid; e < kKC * kTN; e += kThreads) {
        const int n = e % kTN;
        const int ci = e / kTN;
        const int k = k0 + ci;
        const int co = n0 + n;
        s_r[ci][n] = (k < Cres && co < Co) ? to_f32(wres[(size_t)k * Co + co]) : 0.f;
      }
      __syncthreads();
      for (int ci = 0; ci < kKC; ++ci) {
        const float4 wa = *reinterpret_cast<const float4*>(&s_r[ci][cg * kCO]);
        const float4 wb = *reinterpret_cast<const float4*>(&s_r[ci][cg * kCO + 4]);
        const float wv[kCO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int j = 0; j < kPX; ++j) {
          const float xv = s_x[ci][r][c0 + j];
#pragma unroll
          for (int k = 0; k < kCO; ++k) acc[j][k] = fmaf(xv, wv[k], acc[j][k]);
        }
      }
      __syncthreads();
    }
  }

  const int gy = y0 + r;
  if (gy >= H) return;
#pragma unroll
  for (int j = 0; j < kPX; ++j) {
    const int gx = x0 + c0 + j;
    if (gx < W) {
      const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
      for (int k = 0; k < kCO; ++k) {
        const int co = n0 + cg * kCO + k;
        if (co < Co) {
          float v = acc[j][k] + to_f32(bias[co]);
          if constexpr (EPI == kGelu) v = gelu_exact(v);
          if constexpr (EPI == kIdentityRes) v += to_f32(res[pix * Cres + co]);
          if constexpr (EPI == kProjRes) v += to_f32(bres[co]);
          out[pix * Co + co] = from_f32<T>(v);
        }
      }
    }
  }
}

template <typename T, int EPI>
cudaError_t launch_conv3x3(const T* in, int Cin, const T* w, const T* bias, const T* res,
                           int Cres, const T* wres, const T* bres, T* out, int B, int H,
                           int W, int Co, cudaStream_t stream) {
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, (Co + kTN - 1) / kTN, B);
  conv3x3_kernel<T, EPI><<<grid, kThreads, 0, stream>>>(in, Cin, w, bias, res, Cres, wres,
                                                        bres, out, H, W, Co, tiles_w);
  return cudaGetLastError();
}

template <typename T>
int conv_block(const void* h1_, const void* w1_, const void* b1_, const void* w2_,
               const void* b2_, const void* x_, const void* wres_, const void* bres_, void* g_,
               void* out_, int B, int H, int W, int C, int Co, int device, void* stream_) {
  T* g = static_cast<T*>(g_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv3x3<T, kGelu>(static_cast<const T*>(h1_), C, static_cast<const T*>(w1_),
                                 static_cast<const T*>(b1_), nullptr, 0, nullptr, nullptr, g, B,
                                 H, W, Co, stream);
  if (err != cudaSuccess) return (int)err;
  const T* x = static_cast<const T*>(x_);
  if (wres_ == nullptr) {
    err = launch_conv3x3<T, kIdentityRes>(g, Co, static_cast<const T*>(w2_),
                                          static_cast<const T*>(b2_), x, C, nullptr, nullptr,
                                          static_cast<T*>(out_), B, H, W, Co, stream);
  } else {
    err = launch_conv3x3<T, kProjRes>(g, Co, static_cast<const T*>(w2_),
                                      static_cast<const T*>(b2_), x, C,
                                      static_cast<const T*>(wres_), static_cast<const T*>(bres_),
                                      static_cast<T*>(out_), B, H, W, Co, stream);
  }
  return (int)err;
}

}  // namespace sinddm

extern "C" {

// Stages 2 and 3 of the block; h1 (stage 1) comes from dw_conv.cu.
#define SINDDM_CONV_BLOCK_ARGS                                                              \
  const void *h1, const void *w1, const void *b1, const void *w2, const void *b2,           \
      const void *x, const void *wres, const void *bres, void *g, void *out, int B, int H,  \
      int W, int C, int Co, int device, void *stream

int sinddm_conv_block_f32(SINDDM_CONV_BLOCK_ARGS) {
  return sinddm::conv_block<float>(h1, w1, b1, w2, b2, x, wres, bres, g, out, B, H, W, C, Co,
                                   device, stream);
}

int sinddm_conv_block_bf16(SINDDM_CONV_BLOCK_ARGS) {
  return sinddm::conv_block<__nv_bfloat16>(h1, w1, b1, w2, b2, x, wres, bres, g, out, B, H, W,
                                           C, Co, device, stream);
}

const char* sinddm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
