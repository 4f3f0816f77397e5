// Bilinear view warp (the CLIP-guidance augmentation sampler) and its image
// adjoint, batched over images and views, NHWC fp32.
//
//   out[b, q, c] = sum_{y, x} A[q, y] * img[b, y, x, c] * B[q, x] + fill * (1 - cover[q])
//   A[q, y] = relu(1 - |ys[q] - y|),  B[q, x] = relu(1 - |xs[q] - x|),
//   cover[q] = sum_y A[q, y] * sum_x B[q, x]
//
// with y over the H rows and x over the W columns that exist: a tap outside
// the image is dropped, not renormalised, and its weight goes to `fill`.
// coords are (x, y) pairs in source pixels, pixel centres at integers.
//
// Replaces every view-warp kernel of sinddm_tpu/ops/pallas_warp.py, one
// __global__ entry per TPU kernel:
//   warp_whole_fwd_kernel <- _fwd_kernel       (bilinear_sample_pallas)
//   warp_whole_bwd_kernel <- _bwd_kernel       (its adjoint)
//   warp_win_fwd_kernel   <- _fwd_kernel_win   (bilinear_sample_pallas_win)
//   warp_winx_fwd_kernel  <- _fwd_kernel_winx  (bilinear_sample_pallas_winx)
//   warp_winb_fwd_kernel  <- _fwd_kernel_winb  (bilinear_sample_pallas_winb)
//   warp_win_bwd_kernel   <- _bwd_kernel_win   (the adjoint all three share)
//   warp_win3_fwd_kernel  <- _fwd_kernel_win3  (bilinear_sample_pallas_win3)
//   warp_win3_bwd_kernel  <- _bwd_kernel_win3  (its adjoint)
// The TPU kernels turn the sampler into matrix products over a VMEM-resident
// image (the whole image, or a 128-row window of it), because a gather is
// slow there. A hat row has at most two non-zero entries, so here each
// output pixel reads two rows x two columns directly. What stays distinct is
// what is distinct there:
//   whole computes a pixel's C channels in one thread (the TPU kernel builds
//         the taps once a tile and loops over channels), rows first and the
//         sum over x last;
//   win   runs one thread per (pixel, channel), rows first, sum over x last;
//   winx  interpolates along x first and sums over y last (another fp32
//         summation order);
//   winb  is winx with all C channels of a pixel in one thread;
//   win3  is win with the products split into bf16 parts: image and row
//         weights as hi = bf16(v), lo = bf16(v - hi), the row sum as
//         a_hi*i_hi + a_hi*i_lo + a_lo*i_hi (lo*lo dropped) with fp32 sums, the
//         column weights unsplit; its adjoint splits both factors of
//         (A*ct)^T B the same way. A bf16 x bf16 product is exact in fp32, so
//         SIMT fp32 arithmetic on the rounded parts is the TPU kernels'
//         arithmetic up to summation order.
// The adjoints scatter (A * ct)^T B with atomicAdd into a zeroed image
// gradient (the TPU kernels accumulate over a sequential grid instead), so
// their summation order changes from run to run.
//
// Bound on the H100: device-memory bytes. A forward must read the coords
// (8 B a pixel) and the source once (win3: two bf16 planes) and write C
// floats a pixel; an adjoint reads coords and cotangent and zeroes and
// writes the gradient image. The source (a few hundred KB an image) stays in
// L2, so the gathers and the atomics are L2 traffic. Nothing is staged in
// shared memory yet.
//
// C interface, loaded with ctypes: every entry returns the cudaError_t of
// its launch (0 on success) and never synchronises.
#include <cstdint>

#include "common.cuh"

namespace sinddm {

constexpr int kWarpThreads = 256;

// The two taps of one hat row along an axis of n samples: indices clamped
// into the axis (safe to read), weights zero where the tap falls outside it.
struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps hat_taps(float v, int n) {
  Taps t;
  if (!(v > -1.f && v < (float)n)) {  // no tap in range (also NaN)
    t.i0 = t.i1 = 0;
    t.w0 = t.w1 = 0.f;
    return t;
  }
  const float f = floorf(v);
  const int i = (int)f;  // -1 .. n-1
  const float w1 = v - f;
  t.w0 = i >= 0 ? 1.f - w1 : 0.f;
  t.w1 = i + 1 <= n - 1 ? w1 : 0.f;
  t.i0 = max(i, 0);
  t.i1 = min(i + 1, n - 1);
  return t;
}

// hat_taps with the weights formed as the TPU kernels form them,
// relu(1 - |v - i|) at each tap row i. For v in (0, 0.5), fp32 rounds
// 1 - |v - 1| and v - floor(v) differently in the last bit; win3 splits the
// weights into bf16 parts, and a last bit can move a part by a bf16 ulp (a
// rounding tie), so win3 takes the TPU kernel's form.
__device__ __forceinline__ Taps hat_taps_tpu(float v, int n) {
  Taps t = hat_taps(v, n);
  if (t.w0 != 0.f) t.w0 = fmaxf(0.f, 1.f - fabsf(v - (float)t.i0));
  if (t.w1 != 0.f) t.w1 = fmaxf(0.f, 1.f - fabsf(v - (float)t.i1));
  return t;
}

__device__ __forceinline__ float blend_fill(float val, const Taps& ty, const Taps& tx, float fill) {
  const float cover = (ty.w0 + ty.w1) * (tx.w0 + tx.w1);
  return val + fill * (1.f - cover);
}

// img [B, H, W, C], coords [B, N, 2], out [B, N, C]; one thread per (b, q)
// walks the C channels of its four taps. Rows first: a_x = A-weighted column
// sample at each x tap, then the sum over x, as the TPU kernel's A @ img
// slab and its sum(slab * B).
__global__ void __launch_bounds__(kWarpThreads)
warp_whole_fwd_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                      float* __restrict__ out, float fill, int B, int H, int W, int C, int N) {
  const long long p = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (p >= (long long)B * N) return;
  const int b = (int)(p / N);
  const Taps tx = hat_taps(coords[2 * p], W);
  const Taps ty = hat_taps(coords[2 * p + 1], H);
  const float* im = img + (size_t)b * H * W * C;
  const float* p00 = im + ((size_t)ty.i0 * W + tx.i0) * C;
  const float* p01 = im + ((size_t)ty.i0 * W + tx.i1) * C;
  const float* p10 = im + ((size_t)ty.i1 * W + tx.i0) * C;
  const float* p11 = im + ((size_t)ty.i1 * W + tx.i1) * C;
  float* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float a0 = fmaf(ty.w1, p10[c], ty.w0 * p00[c]);
    const float a1 = fmaf(ty.w1, p11[c], ty.w0 * p01[c]);
    o[c] = blend_fill(fmaf(a1, tx.w1, a0 * tx.w0), ty, tx, fill);
  }
}

// Adjoint of the whole-image warp: gimg[b, y, x, c] += (A[q, y] * ct[b, q, c]) * B[q, x],
// one thread per (b, q) over its C channels, up to four atomics a channel.
// gimg is zeroed by the caller (the C entry below).
__global__ void __launch_bounds__(kWarpThreads)
warp_whole_bwd_kernel(const float* __restrict__ ct, const float* __restrict__ coords,
                      float* __restrict__ gimg, int B, int H, int W, int C, int N) {
  const long long p = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (p >= (long long)B * N) return;
  const int b = (int)(p / N);
  const Taps tx = hat_taps(coords[2 * p], W);
  const Taps ty = hat_taps(coords[2 * p + 1], H);
  float* im = gimg + (size_t)b * H * W * C;
  float* p00 = im + ((size_t)ty.i0 * W + tx.i0) * C;
  float* p01 = im + ((size_t)ty.i0 * W + tx.i1) * C;
  float* p10 = im + ((size_t)ty.i1 * W + tx.i0) * C;
  float* p11 = im + ((size_t)ty.i1 * W + tx.i1) * C;
  const float* g = ct + p * C;
  for (int c = 0; c < C; ++c) {
    const float g0 = ty.w0 * g[c], g1 = ty.w1 * g[c];
    if (ty.w0 != 0.f) {
      if (tx.w0 != 0.f) atomicAdd(p00 + c, g0 * tx.w0);
      if (tx.w1 != 0.f) atomicAdd(p01 + c, g0 * tx.w1);
    }
    if (ty.w1 != 0.f) {
      if (tx.w0 != 0.f) atomicAdd(p10 + c, g1 * tx.w0);
      if (tx.w1 != 0.f) atomicAdd(p11 + c, g1 * tx.w1);
    }
  }
}

// img [B, H, W, C], coords [B, N, 2], out [B, N, C]; one thread per (b, q, c).
// Rows first: a_x = A-weighted column sample at each x tap, then sum over x.
__global__ void __launch_bounds__(kWarpThreads)
warp_win_fwd_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                    float* __restrict__ out, float fill, int B, int H, int W, int C, int N) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (i >= (long long)B * N * C) return;
  const int c = (int)(i % C);
  const long long p = i / C;  // b * N + q
  const int b = (int)(p / N);
  const Taps tx = hat_taps(coords[2 * p], W);
  const Taps ty = hat_taps(coords[2 * p + 1], H);
  const float* im = img + (size_t)b * H * W * C + c;
  const float* r0 = im + (size_t)ty.i0 * W * C;
  const float* r1 = im + (size_t)ty.i1 * W * C;
  const float a0 = fmaf(ty.w1, r1[tx.i0 * C], ty.w0 * r0[tx.i0 * C]);
  const float a1 = fmaf(ty.w1, r1[tx.i1 * C], ty.w0 * r0[tx.i1 * C]);
  out[i] = blend_fill(fmaf(a1, tx.w1, a0 * tx.w0), ty, tx, fill);
}

// The same function, columns first: r_y = B-weighted row sample at each y
// tap, then sum over y.
__global__ void __launch_bounds__(kWarpThreads)
warp_winx_fwd_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                     float* __restrict__ out, float fill, int B, int H, int W, int C, int N) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (i >= (long long)B * N * C) return;
  const int c = (int)(i % C);
  const long long p = i / C;
  const int b = (int)(p / N);
  const Taps tx = hat_taps(coords[2 * p], W);
  const Taps ty = hat_taps(coords[2 * p + 1], H);
  const float* im = img + (size_t)b * H * W * C + c;
  const float* r0 = im + (size_t)ty.i0 * W * C;
  const float* r1 = im + (size_t)ty.i1 * W * C;
  const float s0 = fmaf(tx.w1, r0[tx.i1 * C], tx.w0 * r0[tx.i0 * C]);
  const float s1 = fmaf(tx.w1, r1[tx.i1 * C], tx.w0 * r1[tx.i0 * C]);
  out[i] = blend_fill(fmaf(s1, ty.w1, s0 * ty.w0), ty, tx, fill);
}

// winx with the channels batched: one thread per (b, q) computes the tap
// weights once and walks the C contiguous channels of each of the four taps.
__global__ void __launch_bounds__(kWarpThreads)
warp_winb_fwd_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                     float* __restrict__ out, float fill, int B, int H, int W, int C, int N) {
  const long long p = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (p >= (long long)B * N) return;
  const int b = (int)(p / N);
  const Taps tx = hat_taps(coords[2 * p], W);
  const Taps ty = hat_taps(coords[2 * p + 1], H);
  const float* im = img + (size_t)b * H * W * C;
  const float* p00 = im + ((size_t)ty.i0 * W + tx.i0) * C;
  const float* p01 = im + ((size_t)ty.i0 * W + tx.i1) * C;
  const float* p10 = im + ((size_t)ty.i1 * W + tx.i0) * C;
  const float* p11 = im + ((size_t)ty.i1 * W + tx.i1) * C;
  const float rest = fill * (1.f - (ty.w0 + ty.w1) * (tx.w0 + tx.w1));
  float* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float s0 = fmaf(tx.w1, p01[c], tx.w0 * p00[c]);
    const float s1 = fmaf(tx.w1, p11[c], tx.w0 * p10[c]);
    o[c] = fmaf(s1, ty.w1, s0 * ty.w0) + rest;
  }
}

// Adjoint of all three: gimg[b, y, x, c] += A[q, y] * ct[b, q, c] * B[q, x]
// over every pixel q of every view of image b. gimg is zeroed by the caller
// (the C entry below). One thread per (b, q, c), up to four atomics.
__global__ void __launch_bounds__(kWarpThreads)
warp_win_bwd_kernel(const float* __restrict__ ct, const float* __restrict__ coords,
                    float* __restrict__ gimg, int B, int H, int W, int C, int N) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (i >= (long long)B * N * C) return;
  const int c = (int)(i % C);
  const long long p = i / C;
  const int b = (int)(p / N);
  const Taps tx = hat_taps(coords[2 * p], W);
  const Taps ty = hat_taps(coords[2 * p + 1], H);
  const float g = ct[i];
  float* im = gimg + (size_t)b * H * W * C + c;
  float* r0 = im + (size_t)ty.i0 * W * C;
  float* r1 = im + (size_t)ty.i1 * W * C;
  const float g0 = ty.w0 * g, g1 = ty.w1 * g;
  if (ty.w0 != 0.f) {
    if (tx.w0 != 0.f) atomicAdd(r0 + tx.i0 * C, g0 * tx.w0);
    if (tx.w1 != 0.f) atomicAdd(r0 + tx.i1 * C, g0 * tx.w1);
  }
  if (ty.w1 != 0.f) {
    if (tx.w0 != 0.f) atomicAdd(r1 + tx.i0 * C, g1 * tx.w0);
    if (tx.w1 != 0.f) atomicAdd(r1 + tx.i1 * C, g1 * tx.w1);
  }
}

// v = hi + lo with hi = bf16(v), lo = bf16(v - hi), both widened back to fp32.
struct Split {
  float hi, lo;
};

__device__ __forceinline__ Split split_bf16(float v) {
  Split s;
  s.hi = __bfloat162float(__float2bfloat16_rn(v));
  s.lo = __bfloat162float(__float2bfloat16_rn(v - s.hi));
  return s;
}

// a * b by three bf16 x bf16 products, each exact in fp32, summed as the TPU
// kernel sums its three dots: (hi*hi + hi*lo) + lo*hi.
__device__ __forceinline__ float mul3(const Split& a, const Split& b) {
  return fmaf(a.lo, b.hi, fmaf(a.hi, b.lo, a.hi * b.hi));
}

// The windowed warp with split-bf16x3 row products: ihi / ilo [B, H, W, C]
// are the image's bf16 parts, coords [B, N, 2], out [B, N, C]; one thread
// per (b, q, c). At each x tap the row sum over the two y taps is formed dot
// by dot (a_hi.i_hi, a_hi.i_lo, a_lo.i_hi, each over y) and the three dots
// are added, then the column weights (fp32, unsplit) take the sum over x.
__global__ void __launch_bounds__(kWarpThreads)
warp_win3_fwd_kernel(const __nv_bfloat16* __restrict__ ihi, const __nv_bfloat16* __restrict__ ilo,
                     const float* __restrict__ coords, float* __restrict__ out, float fill, int B,
                     int H, int W, int C, int N) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (i >= (long long)B * N * C) return;
  const int c = (int)(i % C);
  const long long p = i / C;
  const int b = (int)(p / N);
  const Taps tx = hat_taps_tpu(coords[2 * p], W);
  const Taps ty = hat_taps_tpu(coords[2 * p + 1], H);
  const Split a0 = split_bf16(ty.w0), a1 = split_bf16(ty.w1);
  const size_t base = (size_t)b * H * W * C + c;
  const size_t r0 = base + (size_t)ty.i0 * W * C, r1 = base + (size_t)ty.i1 * W * C;
  float slab[2];
  const int xs[2] = {tx.i0, tx.i1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const size_t o0 = r0 + (size_t)xs[k] * C, o1 = r1 + (size_t)xs[k] * C;
    const float h0 = __bfloat162float(ihi[o0]), l0 = __bfloat162float(ilo[o0]);
    const float h1 = __bfloat162float(ihi[o1]), l1 = __bfloat162float(ilo[o1]);
    const float hh = fmaf(a1.hi, h1, a0.hi * h0);
    const float hl = fmaf(a1.hi, l1, a0.hi * l0);
    const float lh = fmaf(a1.lo, h1, a0.lo * h0);
    slab[k] = (hh + hl) + lh;
  }
  out[i] = blend_fill(fmaf(slab[1], tx.w1, slab[0] * tx.w0), ty, tx, fill);
}

// Adjoint of win3: gimg[b, y, x, c] += split3(A[q, y] * ct[b, q, c]) x split3(B[q, x]),
// the row factor formed in fp32 first and then split, as the TPU kernel's
// _dotg3(A * ct, B). One thread per (b, q, c), up to four atomics; gimg is
// zeroed by the caller.
__global__ void __launch_bounds__(kWarpThreads)
warp_win3_bwd_kernel(const float* __restrict__ ct, const float* __restrict__ coords,
                     float* __restrict__ gimg, int B, int H, int W, int C, int N) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (i >= (long long)B * N * C) return;
  const int c = (int)(i % C);
  const long long p = i / C;
  const int b = (int)(p / N);
  const Taps tx = hat_taps_tpu(coords[2 * p], W);
  const Taps ty = hat_taps_tpu(coords[2 * p + 1], H);
  const float g = ct[i];
  float* im = gimg + (size_t)b * H * W * C + c;
  const Split b0 = split_bf16(tx.w0), b1 = split_bf16(tx.w1);
  const float wy[2] = {ty.w0, ty.w1};
  const int ys[2] = {ty.i0, ty.i1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (wy[j] == 0.f) continue;
    const Split gy = split_bf16(wy[j] * g);
    float* row = im + (size_t)ys[j] * W * C;
    if (tx.w0 != 0.f) atomicAdd(row + (size_t)tx.i0 * C, mul3(gy, b0));
    if (tx.w1 != 0.f) atomicAdd(row + (size_t)tx.i1 * C, mul3(gy, b1));
  }
}

inline int blocks_for(long long n) { return (int)((n + kWarpThreads - 1) / kWarpThreads); }

}  // namespace sinddm

extern "C" {

// img [B,H,W,C], coords [B,N,2] -> out [B,N,C]; B*N*C < 2^31.
int sinddm_warp_whole_fwd(const void* img, const void* coords, void* out, float fill, int B, int H,
                          int W, int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_whole_fwd_kernel<<<sinddm::blocks_for((long long)B * N), sinddm::kWarpThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(coords), static_cast<float*>(out),
      fill, B, H, W, C, N);
  return (int)cudaGetLastError();
}

// ct [B,N,C], coords [B,N,2] -> gimg [B,H,W,C], zeroed here first.
int sinddm_warp_whole_bwd(const void* ct, const void* coords, void* gimg, int B, int H, int W,
                          int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(gimg, 0, (size_t)B * H * W * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_whole_bwd_kernel<<<sinddm::blocks_for((long long)B * N), sinddm::kWarpThreads, 0,
                                  s>>>(static_cast<const float*>(ct),
                                       static_cast<const float*>(coords),
                                       static_cast<float*>(gimg), B, H, W, C, N);
  return (int)cudaGetLastError();
}

int sinddm_warp_win_fwd(const void* img, const void* coords, void* out, float fill, int B, int H,
                        int W, int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_win_fwd_kernel<<<sinddm::blocks_for((long long)B * N * C), sinddm::kWarpThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(coords), static_cast<float*>(out),
      fill, B, H, W, C, N);
  return (int)cudaGetLastError();
}

int sinddm_warp_winx_fwd(const void* img, const void* coords, void* out, float fill, int B, int H,
                         int W, int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_winx_fwd_kernel<<<sinddm::blocks_for((long long)B * N * C), sinddm::kWarpThreads,
                                 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(coords), static_cast<float*>(out),
      fill, B, H, W, C, N);
  return (int)cudaGetLastError();
}

int sinddm_warp_winb_fwd(const void* img, const void* coords, void* out, float fill, int B, int H,
                         int W, int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_winb_fwd_kernel<<<sinddm::blocks_for((long long)B * N), sinddm::kWarpThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(coords), static_cast<float*>(out),
      fill, B, H, W, C, N);
  return (int)cudaGetLastError();
}

// ct [B,N,C], coords [B,N,2] -> gimg [B,H,W,C], zeroed here first.
int sinddm_warp_win_bwd(const void* ct, const void* coords, void* gimg, int B, int H, int W, int C,
                        int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(gimg, 0, (size_t)B * H * W * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_win_bwd_kernel<<<sinddm::blocks_for((long long)B * N * C), sinddm::kWarpThreads, 0,
                                s>>>(static_cast<const float*>(ct),
                                     static_cast<const float*>(coords), static_cast<float*>(gimg),
                                     B, H, W, C, N);
  return (int)cudaGetLastError();
}

// ihi, ilo bf16 [B,H,W,C] (the image's split), coords [B,N,2] -> out [B,N,C].
int sinddm_warp_win3_fwd(const void* ihi, const void* ilo, const void* coords, void* out,
                         float fill, int B, int H, int W, int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_win3_fwd_kernel<<<sinddm::blocks_for((long long)B * N * C), sinddm::kWarpThreads,
                                 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ihi), static_cast<const __nv_bfloat16*>(ilo),
      static_cast<const float*>(coords), static_cast<float*>(out), fill, B, H, W, C, N);
  return (int)cudaGetLastError();
}

// ct [B,N,C], coords [B,N,2] -> gimg [B,H,W,C], zeroed here first.
int sinddm_warp_win3_bwd(const void* ct, const void* coords, void* gimg, int B, int H, int W,
                         int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(gimg, 0, (size_t)B * H * W * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  sinddm::warp_win3_bwd_kernel<<<sinddm::blocks_for((long long)B * N * C), sinddm::kWarpThreads,
                                 0, s>>>(static_cast<const float*>(ct),
                                         static_cast<const float*>(coords),
                                         static_cast<float*>(gimg), B, H, W, C, N);
  return (int)cudaGetLastError();
}

const char* sinddm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
