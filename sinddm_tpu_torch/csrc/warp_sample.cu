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
// Replaces the windowed fp32 family of sinddm_tpu/ops/pallas_warp.py, one
// __global__ entry per TPU kernel:
//   warp_win_fwd_kernel   <- _fwd_kernel_win   (bilinear_sample_pallas_win)
//   warp_winx_fwd_kernel  <- _fwd_kernel_winx  (bilinear_sample_pallas_winx)
//   warp_winb_fwd_kernel  <- _fwd_kernel_winb  (bilinear_sample_pallas_winb)
//   warp_win_bwd_kernel   <- _bwd_kernel_win   (the adjoint all three share)
// The TPU kernels turn the sampler into matrix products over a 128-row
// window of a VMEM-resident image, because a gather is slow there. A hat row
// has at most two non-zero entries, so here each output pixel reads two rows
// x two columns directly. What stays distinct is what is distinct there:
//   win   interpolates along y first and sums over x last;
//   winx  interpolates along x first and sums over y last (another fp32
//         summation order);
//   winb  is winx with all C channels of a pixel in one thread, so the tap
//         weights are computed once a pixel and a tap's channels are read
//         together, where win / winx run one thread per (pixel, channel).
// The adjoint scatters (A * ct)^T B with atomicAdd into a zeroed image
// gradient (the TPU kernel accumulates over a sequential grid instead), so
// its summation order changes from run to run.
//
// Bound on the H100: device-memory bytes. The forward must read the coords
// (8 B a pixel) and the source once and write C floats a pixel; the adjoint
// reads coords and cotangent and zeroes and writes the gradient image. The
// source (a few hundred KB an image) stays in L2, so the gathers and the
// atomics are L2 traffic. Nothing is staged in shared memory yet.
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

__device__ __forceinline__ float blend_fill(float val, const Taps& ty, const Taps& tx, float fill) {
  const float cover = (ty.w0 + ty.w1) * (tx.w0 + tx.w1);
  return val + fill * (1.f - cover);
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

inline int blocks_for(long long n) { return (int)((n + kWarpThreads - 1) / kWarpThreads); }

}  // namespace sinddm

extern "C" {

// img [B,H,W,C], coords [B,N,2] -> out [B,N,C]; B*N*C < 2^31.
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

const char* sinddm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
