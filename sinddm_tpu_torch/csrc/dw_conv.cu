// SAME 5x5 depthwise convolution + bias (+ an optional per-batch vector),
// NHWC, true fp32 accumulation: 25 fmaf per output, never TF32.
//
// Replaces the TPU kernel sinddm_tpu/ops/pallas_dw.py `_dw_kernel`
// (entry `depthwise_conv5x5`), whose point was precision: fp32 FMAs where
// XLA's TPU convolution took bf16 passes. It is also the first stage of the
// conv block (sinddm_tpu/ops/pallas_conv.py `_conv_block_kernel`:
// dw5x5 + bias + cond), where the per-batch vector is the block's projected
// condition; conv_block.cu runs the block's two 3x3 stages after it.
//
// Bound on the H100: device-memory bytes. At [16,186,248,160] fp32 the
// kernel must read 472 MB and write 472 MB, 0.28 ms at 3.35 TB/s, against
// 3.7 GFLOP (0.06 ms at the 67 TFLOP/s fp32 rate). The design reads x once
// from device memory and keeps load instructions few: where C % 4 == 0 and
// the pointers are 16-byte aligned (C = 80 and 160 on the sampling path), a
// thread computes 4 channels x 4 neighbouring columns from 16-byte (fp32) or
// 8-byte (bf16) loads, 5 x (8 input + 5 weight) vector loads for 16 outputs,
// and neighbouring threads take neighbouring channels, so each load is
// coalesced and the taps of nearby pixels hit L1. Other shapes (l1's C = 3)
// take the scalar kernel: one output a thread, a warp across 32 channels.
//
// Types: T = float, or __nv_bfloat16 (the conv block's bf16 mode) with the
// sum kept in fp32 and rounded once at the store.
//
// C interface, loaded with ctypes: every entry returns the cudaError_t of
// its launch (0 on success) and never synchronises.
#include <cstdint>

#include "common.cuh"

namespace sinddm {

constexpr int kDwThreads = 256;

// out[b,y,x,c] = sum_{di,dj} x[b,y+di-2,x+dj-2,c] * w[di,dj,c] + bias[c] (+ vec[b,c])
// Zero padding outside the image. `vec` may be null. B*H*W*C < 2^31.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
dw5x5_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
             const T* __restrict__ vec, T* __restrict__ out, int B, int H, int W, int C) {
  const int n = B * H * W * C;
  const int i = blockIdx.x * kDwThreads + threadIdx.x;
  if (i >= n) return;
  const int c = i % C;
  int p = i / C;
  const int xw = p % W;
  p /= W;
  const int y = p % H;
  const int b = p / H;

  float acc = 0.f;
#pragma unroll
  for (int di = 0; di < 5; ++di) {
    const int yy = y + di - 2;
    if (yy < 0 || yy >= H) continue;
    const T* row = x + ((size_t)(b * H + yy) * W) * C + c;
#pragma unroll
    for (int dj = 0; dj < 5; ++dj) {
      const int xx = xw + dj - 2;
      if (xx < 0 || xx >= W) continue;
      acc = fmaf(to_f32(row[(size_t)xx * C]), to_f32(w[(di * 5 + dj) * C + c]), acc);
    }
  }
  acc += to_f32(bias[c]);
  if (vec != nullptr) acc += to_f32(vec[b * C + c]);
  out[i] = from_f32<T>(acc);
}

// Four consecutive channels as one aligned load / store.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(q);
}

constexpr int kPxw = 4;  // output columns per thread in the vector kernel

// The same function for C % 4 == 0 and aligned pointers: thread i computes
// channels 4*(i % (C/4)) .. +3 at kPxw neighbouring columns. Each output sums
// its 25 taps in the scalar kernel's order (rows, then columns).
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
dw5x5_vec_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                 const T* __restrict__ vec, T* __restrict__ out, int B, int H, int W, int C) {
  const int c4s = C / 4;
  const int wg = (W + kPxw - 1) / kPxw;
  const int n = B * H * wg * c4s;
  const int i = blockIdx.x * kDwThreads + threadIdx.x;
  if (i >= n) return;
  const int c = (i % c4s) * 4;
  int p = i / c4s;
  const int x0 = (p % wg) * kPxw;
  p /= wg;
  const int y = p % H;
  const int b = p / H;

  float acc[kPxw][4] = {};
#pragma unroll
  for (int di = 0; di < 5; ++di) {
    const int yy = y + di - 2;
    if (yy < 0 || yy >= H) continue;
    float wv[5][4];
#pragma unroll
    for (int dj = 0; dj < 5; ++dj) load4(w + (di * 5 + dj) * C + c, wv[dj]);
    const T* row = x + ((size_t)(b * H + yy) * W) * C + c;
#pragma unroll
    for (int col = 0; col < kPxw + 4; ++col) {  // input column x0 + col - 2
      const int xx = x0 + col - 2;
      if (xx < 0 || xx >= W) continue;
      float v[4];
      load4(row + (size_t)xx * C, v);
#pragma unroll
      for (int dj = 0; dj < 5; ++dj) {
        const int j = col - dj;  // the output column this tap feeds
        if (j < 0 || j >= kPxw) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(v[k], wv[dj][k], acc[j][k]);
      }
    }
  }
  float bv[4], vv[4] = {0.f, 0.f, 0.f, 0.f};
  load4(bias + c, bv);
  if (vec != nullptr) load4(vec + b * C + c, vv);
#pragma unroll
  for (int j = 0; j < kPxw; ++j) {
    if (x0 + j >= W) break;
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = vec != nullptr ? (acc[j][k] + bv[k]) + vv[k] : acc[j][k] + bv[k];
    store4(out + ((size_t)(b * H + y) * W + x0 + j) * C + c, o);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int dw5x5(const void* x, const void* w, const void* bias, const void* vec, void* out, int B,
          int H, int W, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto s = static_cast<cudaStream_t>(stream);
  const T *xt = static_cast<const T*>(x), *wt = static_cast<const T*>(w);
  const T *bt = static_cast<const T*>(bias), *vt = static_cast<const T*>(vec);
  T* ot = static_cast<T*>(out);
  if (C % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(bias) && aligned16(out) &&
      (vec == nullptr || aligned16(vec))) {
    const int n = B * H * ((W + kPxw - 1) / kPxw) * (C / 4);
    dw5x5_vec_kernel<T><<<(n + kDwThreads - 1) / kDwThreads, kDwThreads, 0, s>>>(
        xt, wt, bt, vt, ot, B, H, W, C);
  } else {
    const int n = B * H * W * C;
    dw5x5_kernel<T><<<(n + kDwThreads - 1) / kDwThreads, kDwThreads, 0, s>>>(
        xt, wt, bt, vt, ot, B, H, W, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace sinddm

extern "C" {

int sinddm_dw_conv5x5_f32(const void* x, const void* w, const void* bias, const void* vec,
                          void* out, int B, int H, int W, int C, int device, void* stream) {
  return sinddm::dw5x5<float>(x, w, bias, vec, out, B, H, W, C, device, stream);
}

int sinddm_dw_conv5x5_bf16(const void* x, const void* w, const void* bias, const void* vec,
                           void* out, int B, int H, int W, int C, int device, void* stream) {
  return sinddm::dw5x5<__nv_bfloat16>(x, w, bias, vec, out, B, H, W, C, device, stream);
}

const char* sinddm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
