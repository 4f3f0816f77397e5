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
//   win   rows first, sum over x last;
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
// (8 B a pixel) and the source once and write C floats a pixel; an adjoint
// reads coords and cotangent and zeroes and writes the gradient image. The
// source (a few hundred KB an image) stays in L2, so the gathers and the
// atomics are L2 traffic.
//
// win, winx and win3 (the guided default and its two other summation
// orders) run a block on a run of 1024 consecutive samples, a thread 8
// samples with their channels in registers (taps and weight splits formed
// once a sample), 32-bit indices, one division a block and none a thread. On
// the card the gathers do not bound them, the per-sample stream and its
// latency do: coords in and outputs out (the bytes bound). So a thread keeps
// its 8 samples' loads in flight together, coords load as float2, outputs
// leave through shared memory as 16-byte stores, each warp-wide and
// contiguous, and win3 splits the fp32 image in the kernel (one launch, no
// split passes). 2-D patches of a view with their source box staged in
// shared memory (cp.async) measured slower for these forwards: cheaper
// gathers did not repay the box's reduction, barriers and copy (PERF.md).
// The whole-image adjoint is the other way round: its atomics, not
// its stream, bound it, so it takes a 2-D patch of a view and sums the
// patch's terms in a shared-memory box before one coalesced global atomic
// an element. whole, winb and the win and win3 adjoints still run a thread a
// sample (or a sample-channel).
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

// a * b by three bf16 x bf16 products, each exact in fp32, summed as the TPU
// kernel sums its three dots: (hi*hi + hi*lo) + lo*hi.
__device__ __forceinline__ float mul3(const Split& a, const Split& b) {
  return fmaf(a.lo, b.hi, fmaf(a.hi, b.lo, a.hi * b.hi));
}

// ---- the win, winx and win3 forwards: a run of samples a block -------------
//
// A block computes kRun consecutive samples of one image (blockIdx.x =
// image * runs + run), a thread kRowsPerWarp samples with their C channels
// in registers, 32-bit indices throughout. Warp w takes the rows of
// 32 samples w, w + kWarps, ... of the run, so each load of coords and each
// store of outputs is one contiguous warp-wide access. The taps come from
// global memory through the read-only path (the source, a few hundred KB an
// image, stays in L2); win3 splits each tap into its bf16 parts as it reads
// it, so its entry is one launch over the fp32 image. With C = 3 (the
// path's) a warp's outputs are staged in shared memory at the alignment of
// their place in `out` and leave as 16-byte stores; with C at run time each
// sample's channels go straight to `out`.
constexpr int kTileW = 32;                            // a row of samples is one warp's
constexpr int kWarps = 4;                             // a block
constexpr int kRowsPerWarp = 8;                       // rows warp, warp + kWarps, ...
constexpr int kRun = kTileW * kWarps * kRowsPerWarp;  // samples a block
constexpr int kTileThreads = kTileW * kWarps;

// n outputs of a row from shared memory (src at the alignment of dst mod 16
// bytes, shift floats past a boundary) to dst: a scalar head to the 16-byte
// boundary, float4s, a scalar tail; one warp.
__device__ __forceinline__ void store_row(float* dst, const float* src, int n, int shift, int lane) {
  const int head = min(n, (4 - shift) & 3);
  const int nv = (n - head) >> 2;
  for (int i = lane; i < head; i += kTileW) dst[i] = src[i];
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int i = lane; i < nv; i += kTileW) d4[i] = s4[i];
  for (int i = head + 4 * nv + lane; i < n; i += kTileW) dst[i] = src[i];
}

// A tap's value, 0 where the tap carries no weight (the kernels that run a
// thread a sample read a clamped pixel there and multiply it by 0).
__device__ __forceinline__ float tap_f32(const float* src, int i, bool ok) {
  return ok ? __ldg(src + i) : 0.f;
}

// The bf16 parts of two taps (rows 0 and 1 at one column), both roundings
// of each step in one packed conversion: split_bf16 of each, bit for bit.
struct Split2 {
  Split a, b;
};

__device__ __forceinline__ Split2 tap_split2(const float* src, int i, bool ok_i, int j, bool ok_j) {
  const float u = tap_f32(src, i, ok_i), v = tap_f32(src, j, ok_j);
  Split2 s;
  const __nv_bfloat162 hi = __floats2bfloat162_rn(u, v);
  s.a.hi = __low2float(hi);
  s.b.hi = __high2float(hi);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(u - s.a.hi, v - s.b.hi);
  s.a.lo = __low2float(lo);
  s.b.lo = __high2float(lo);
  return s;
}

// The summation order of a sample's value, one per forward on the run skeleton:
//   kXFirst (winx): along x first, s_y = B-weighted row sample at each y
//            tap, then the sum over y;
//   kYFirst (win):  rows first, a_x = A-weighted column sample at each x tap,
//            then the sum over x, as the TPU kernel's A @ img slab and its
//            sum(slab * B);
//   kSplit3 (win3): at each x tap the row sum over the two y taps formed dot
//            by dot (a_hi.i_hi, a_hi.i_lo, a_lo.i_hi, each over y) and the
//            three dots added, then the column weights (fp32, unsplit) take
//            the sum over x.
enum class Order { kXFirst, kYFirst, kSplit3 };

// One sample's C channels into dst[0, C). off / ok: the taps (row 0, col 0),
// (row 0, col 1), (row 1, col 0), (row 1, col 1) as offsets into src and
// whether each carries weight.
template <int kC, Order kOrder>
__device__ __forceinline__ void run_sample(const float* src, const int (&off)[4], const bool (&ok)[4],
                                           int C, const Taps& ty, const Taps& tx, float fill,
                                           float* dst) {
  const int nc = kC > 0 ? kC : C;
  if constexpr (kOrder == Order::kSplit3) {
    const Split a0 = split_bf16(ty.w0), a1 = split_bf16(ty.w1);
    for (int c = 0; c < nc; ++c) {
      float slab[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const Split2 i = tap_split2(src, off[k] + c, ok[k], off[2 + k] + c, ok[2 + k]);
        const Split &i0 = i.a, &i1 = i.b;
        const float hh = fmaf(a1.hi, i1.hi, a0.hi * i0.hi);
        const float hl = fmaf(a1.hi, i1.lo, a0.hi * i0.lo);
        const float lh = fmaf(a1.lo, i1.hi, a0.lo * i0.hi);
        slab[k] = (hh + hl) + lh;
      }
      dst[c] = blend_fill(fmaf(slab[1], tx.w1, slab[0] * tx.w0), ty, tx, fill);
    }
  } else {
    for (int c = 0; c < nc; ++c) {
      const float v00 = tap_f32(src, off[0] + c, ok[0]);
      const float v01 = tap_f32(src, off[1] + c, ok[1]);
      const float v10 = tap_f32(src, off[2] + c, ok[2]);
      const float v11 = tap_f32(src, off[3] + c, ok[3]);
      if constexpr (kOrder == Order::kXFirst) {
        const float s0 = fmaf(tx.w1, v01, tx.w0 * v00);
        const float s1 = fmaf(tx.w1, v11, tx.w0 * v10);
        dst[c] = blend_fill(fmaf(s1, ty.w1, s0 * ty.w0), ty, tx, fill);
      } else {
        const float a0 = fmaf(ty.w1, v10, ty.w0 * v00);
        const float a1 = fmaf(ty.w1, v11, ty.w0 * v01);
        dst[c] = blend_fill(fmaf(a1, tx.w1, a0 * tx.w0), ty, tx, fill);
      }
    }
  }
}

// img [B, H, W, C] fp32, coords [B, N, 2], out [B, N, C]; block
// b * runs + r computes samples [r * kRun, (r + 1) * kRun) of image b. kC = 3
// is the guided path's; kC = 0 takes C at run time. The body of
// warp_winx_fwd_kernel, warp_win_fwd_kernel and warp_win3_fwd_kernel.
template <int kC, Order kOrder>
__device__ __forceinline__ void run_fwd(const float* __restrict__ img, const float2* __restrict__ coords,
                                        float* __restrict__ out, float fill, int H, int W, int C_,
                                        int N, int runs) {
  constexpr int kStride = kTileW * kC + 4;  // a staged row of outputs, room to shift it
  __shared__ __align__(16) float smem[kC > 0 ? kWarps * kRowsPerWarp * kStride : 1];
  const int C = kC > 0 ? kC : C_;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int b = blockIdx.x / runs;
  const int q0 = (blockIdx.x - b * runs) * kRun;
  const float* im = img + b * H * W * C;

  // the coords of all the thread's samples in flight at once; (-2, -2) has no tap
  float2 xy[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int q = q0 + (warp + kWarps * k) * kTileW + lane;
    xy[k] = q < N ? coords[b * N + q] : make_float2(-2.f, -2.f);
  }
  const auto sample = [&](int k, float* dst) {
    constexpr bool kTpuWeights = kOrder == Order::kSplit3;
    const Taps ty = kTpuWeights ? hat_taps_tpu(xy[k].y, H) : hat_taps(xy[k].y, H);
    const Taps tx = kTpuWeights ? hat_taps_tpu(xy[k].x, W) : hat_taps(xy[k].x, W);
    const bool r0 = ty.w0 != 0.f, r1 = ty.w1 != 0.f, c0 = tx.w0 != 0.f, c1 = tx.w1 != 0.f;
    const bool ok[4] = {r0 && c0, r0 && c1, r1 && c0, r1 && c1};
    const int s0 = ty.i0 * W * C, s1 = ty.i1 * W * C, k0 = tx.i0 * C, k1 = tx.i1 * C;
    const int off[4] = {s0 + k0, s0 + k1, s1 + k0, s1 + k1};
    run_sample<kC, kOrder>(im, off, ok, C, ty, tx, fill, dst);
  };

  if constexpr (kC == 0) {
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int q = q0 + (warp + kWarps * k) * kTileW + lane;
      if (q < N) sample(k, out + (b * N + q) * C);
    }
  } else {
    // every row's samples into the warp's staging rows, each row at the
    // alignment of its place in out; then the rows leave together
    const unsigned out_shift = static_cast<unsigned>(reinterpret_cast<uintptr_t>(out) >> 2);
    const auto shift = [&](int first) {
      return static_cast<int>((out_shift + static_cast<unsigned>((b * N + first) * kC)) & 3u);
    };
    float* so = smem + warp * kRowsPerWarp * kStride;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int first = q0 + (warp + kWarps * k) * kTileW;  // the row's first sample
      if (first + lane < N) sample(k, so + k * kStride + shift(first) + lane * kC);
    }
    __syncwarp();
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int first = q0 + (warp + kWarps * k) * kTileW;
      if (first >= N) break;  // warp-uniform: later rows lie further on
      const int sh = shift(first);
      store_row(out + (b * N + first) * kC, so + k * kStride + sh, min(kTileW, N - first) * kC, sh, lane);
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kTileThreads, 8)
warp_winx_fwd_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                     float* __restrict__ out, float fill, int H, int W, int C, int N, int runs) {
  run_fwd<kC, Order::kXFirst>(img, coords, out, fill, H, W, C, N, runs);
}

template <int kC>
__global__ void __launch_bounds__(kTileThreads, 8)
warp_win_fwd_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                    float* __restrict__ out, float fill, int H, int W, int C, int N, int runs) {
  run_fwd<kC, Order::kYFirst>(img, coords, out, fill, H, W, C, N, runs);
}

template <int kC>
__global__ void __launch_bounds__(kTileThreads, 8)
warp_win3_fwd_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                     float* __restrict__ out, float fill, int H, int W, int C, int N, int runs) {
  run_fwd<kC, Order::kSplit3>(img, coords, out, fill, H, W, C, N, runs);
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

// ---- the whole-image adjoint: a 2-D patch of a view a block -----------------
//
// gimg[b, y, x, c] = sum_q A[q, y] ct[b, q, c] B[q, x] over the N samples of
// image b, replacing _bwd_kernel (sinddm_tpu/ops/pallas_warp.py, the
// bilinear_sample_pallas adjoint). The samples are frames FW columns wide,
// row after row (the views' rows one after another; flat coords are one row
// of N). What bounds it on the card is the atomics: each sample adds up to
// 4 x C terms, and a view magnifies its crop, so neighbouring samples share
// tap pixels and their atomics on one address serialise in L2 (a thread a
// sample issuing them straight to the gradient took 0.63 ms at the path's
// shapes on an H100 80GB HBM3 at 700 W, 11x the bytes bound; PERF.md). So a block takes a patch of kPatch samples, PH x PW
// of the frame (32 x 32; 1 x 1024 on a one-row frame; PW a power of two of
// at least 32), a thread kPerThread consecutive samples of a patch row
// (coords as float2, the cotangent as C contiguous floats a sample). The
// samples' weighted taps span a box of the source, reduced over the block
// by warp reductions and one barrier. Where the box's C channels fit
// kBoxFloats the block zeroes the box in shared memory, adds every term there
// with shared-memory atomics, and flushes it with one global atomicAdd per
// non-zero element, a warp on a box row (C x width contiguous floats in
// NHWC): about a sixth of the global atomics, coalesced. A patch whose box
// does not fit (coords scattered over the source, many channels) adds its
// terms straight to global memory in the same kernel. Both kinds of atomics
// land in an order that changes from run to run.
//
// A float atomicAdd on shared memory is a compare-and-swap loop on sm_90
// (ATOMS.CAST.SPIN), so the shared-memory adds are what the kernel spends
// its time on, and they want threads in flight: 512 threads a block at 4
// blocks an SM (32 registers, 8 bytes spilled) keep 2048 on each SM (256
// threads at 93 registers, 2 blocks an SM, took 1.4x as long on the same
// card), and lanes two samples apart retry less on a shared tap than
// neighbours do (PERF.md).
constexpr int kPatchLog2 = 10;
constexpr int kPatch = 1 << kPatchLog2;  // samples a block
constexpr int kPatchThreads = 512;
constexpr int kPatchWarps = kPatchThreads / 32;
constexpr int kPerThread = kPatch / kPatchThreads;
constexpr int kBoxFloats = 8192;  // 32 KB of shared memory

// The first and last tap of an axis that carry weight (call only where one does).
__device__ __forceinline__ int tap_lo(const Taps& t) { return t.w0 != 0.f ? t.i0 : t.i1; }
__device__ __forceinline__ int tap_hi(const Taps& t) { return t.w1 != 0.f ? t.i1 : t.i0; }
__device__ __forceinline__ bool has_tap(const Taps& t) { return t.w0 != 0.f || t.w1 != 0.f; }

// A sample's up-to-four terms (ty.w_j * g) * tx.w_i of one channel, added at
// dst + row_j + col_i (offsets in floats into shared or global memory).
__device__ __forceinline__ void scatter4(float* dst, int row0, int row1, int col0, int col1,
                                         const Taps& ty, const Taps& tx, float g) {
  const float g0 = ty.w0 * g, g1 = ty.w1 * g;
  if (ty.w0 != 0.f) {
    if (tx.w0 != 0.f) atomicAdd(dst + row0 + col0, g0 * tx.w0);
    if (tx.w1 != 0.f) atomicAdd(dst + row0 + col1, g0 * tx.w1);
  }
  if (ty.w1 != 0.f) {
    if (tx.w0 != 0.f) atomicAdd(dst + row1 + col0, g1 * tx.w0);
    if (tx.w1 != 0.f) atomicAdd(dst + row1 + col1, g1 * tx.w1);
  }
}

// ct [B, N, C], coords [B, N] (x, y), gimg [B, H, W, C] zeroed by the caller;
// block b * tiles + t takes patch t (row-major over col_tiles patches a row
// of patches) of image b. kC = 3 is the path's, its cotangent loaded before
// the box is known; kC = 0 takes C at run time.
template <int kC>
__global__ void __launch_bounds__(kPatchThreads, 4)
warp_whole_bwd_kernel(const float* __restrict__ ct, const float2* __restrict__ coords,
                      float* __restrict__ gimg, int H, int W, int C_, int N, int FW, int pw_log2,
                      int col_tiles, int tiles) {
  __shared__ float box[kBoxFloats];
  __shared__ int warp_box[kPatchWarps][4];
  const int C = kC > 0 ? kC : C_;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int tile_row = tile / col_tiles;
  const int row0 = tile_row << (kPatchLog2 - pw_log2);
  const int col0 = (tile - tile_row * col_tiles) << pw_log2;
  const int rows = N / FW;

  // the thread's samples: taps, and the box of their weighted ones
  Taps ty[kPerThread], tx[kPerThread];
  int q[kPerThread];
  bool live[kPerThread];  // the sample has a weighted tap
  float g[kPerThread][kC > 0 ? kC : 1];
  int x_lo = W, x_hi = -1, y_lo = H, y_hi = -1;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = threadIdx.x * kPerThread + k;  // lanes kPerThread samples apart
    const int row = row0 + (s >> pw_log2), col = col0 + (s & ((1 << pw_log2) - 1));
    const bool in = row < rows && col < FW;
    q[k] = b * N + row * FW + col;
    const float2 xy = in ? coords[q[k]] : make_float2(-2.f, -2.f);  // (-2, -2) has no tap
    if constexpr (kC > 0) {
#pragma unroll
      for (int c = 0; c < kC; ++c) g[k][c] = in ? ct[q[k] * kC + c] : 0.f;
    }
    ty[k] = hat_taps(xy.y, H);
    tx[k] = hat_taps(xy.x, W);
    live[k] = has_tap(ty[k]) && has_tap(tx[k]);
    if (live[k]) {
      x_lo = min(x_lo, tap_lo(tx[k]));
      x_hi = max(x_hi, tap_hi(tx[k]));
      y_lo = min(y_lo, tap_lo(ty[k]));
      y_hi = max(y_hi, tap_hi(ty[k]));
    }
  }
  x_lo = __reduce_min_sync(0xffffffffu, x_lo);
  x_hi = __reduce_max_sync(0xffffffffu, x_hi);
  y_lo = __reduce_min_sync(0xffffffffu, y_lo);
  y_hi = __reduce_max_sync(0xffffffffu, y_hi);
  if (lane == 0) {
    warp_box[warp][0] = x_lo;
    warp_box[warp][1] = x_hi;
    warp_box[warp][2] = y_lo;
    warp_box[warp][3] = y_hi;
  }
  __syncthreads();
  {  // lane w of every warp takes warp w's box (lanes past the last warp take warp 0's)
    const int w = lane < kPatchWarps ? lane : 0;
    x_lo = __reduce_min_sync(0xffffffffu, warp_box[w][0]);
    x_hi = __reduce_max_sync(0xffffffffu, warp_box[w][1]);
    y_lo = __reduce_min_sync(0xffffffffu, warp_box[w][2]);
    y_hi = __reduce_max_sync(0xffffffffu, warp_box[w][3]);
  }
  if (x_hi < 0) return;  // no weighted tap in the patch (block-uniform)

  const auto grad = [&](int k, int c) -> float {
    if constexpr (kC > 0) {
      return g[k][c];
    } else {
      return ct[q[k] * C + c];
    }
  };
  float* im = gimg + b * H * W * C;
  const int bw = x_hi - x_lo + 1, bh = y_hi - y_lo + 1, row_len = bw * C;
  if (bh * row_len > kBoxFloats) {  // the box does not fit: every term straight to the gradient
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!live[k]) continue;
      const int r0 = ty[k].i0 * W * C, r1 = ty[k].i1 * W * C, c0 = tx[k].i0 * C, c1 = tx[k].i1 * C;
      for (int c = 0; c < C; ++c) scatter4(im + c, r0, r1, c0, c1, ty[k], tx[k], grad(k, c));
    }
    return;
  }
  for (int i = threadIdx.x; i < bh * row_len; i += kPatchThreads) box[i] = 0.f;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (!live[k]) continue;
    // offsets of taps without weight may leave the box; scatter4 skips them
    const int r0 = (ty[k].i0 - y_lo) * row_len, r1 = (ty[k].i1 - y_lo) * row_len;
    const int c0 = (tx[k].i0 - x_lo) * C, c1 = (tx[k].i1 - x_lo) * C;
    for (int c = 0; c < C; ++c) scatter4(box + c, r0, r1, c0, c1, ty[k], tx[k], grad(k, c));
  }
  __syncthreads();
  for (int r = warp; r < bh; r += kPatchWarps) {
    const float* src = box + r * row_len;
    float* dst = im + ((y_lo + r) * W + x_lo) * C;
    for (int i = lane; i < row_len; i += 32) {
      const float v = src[i];
      if (v != 0.f) atomicAdd(dst + i, v);
    }
  }
}

inline int blocks_for(long long n) { return (int)((n + kWarpThreads - 1) / kWarpThreads); }

// One launch of the run-skeleton forward of order kOrder: B x runs blocks
// of (kTileW, kWarps) threads, B * N * C < 2^31.
template <Order kOrder>
int launch_run_fwd(const void* img, const void* coords, void* out, float fill, int B, int H, int W,
                   int C, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N == 0) return 0;
  const int runs = (N + kRun - 1) / kRun;
  using Kernel = void (*)(const float*, const float2*, float*, float, int, int, int, int, int);
  Kernel kernel;
  if constexpr (kOrder == Order::kXFirst) {
    kernel = C == 3 ? &warp_winx_fwd_kernel<3> : &warp_winx_fwd_kernel<0>;
  } else if constexpr (kOrder == Order::kYFirst) {
    kernel = C == 3 ? &warp_win_fwd_kernel<3> : &warp_win_fwd_kernel<0>;
  } else {
    kernel = C == 3 ? &warp_win3_fwd_kernel<3> : &warp_win3_fwd_kernel<0>;
  }
  kernel<<<B * runs, dim3(kTileW, kWarps), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float2*>(coords), static_cast<float*>(out), fill,
      H, W, C, N, runs);
  return (int)cudaGetLastError();
}

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

// ct [B,N,C], coords [B,N,2] (8-byte aligned) -> gimg [B,H,W,C], zeroed here
// first. The samples are frames frame_w wide (frame_w divides N); a block
// takes kPatch / patch_w rows x patch_w columns of them, patch_w a power of
// two from 32 to kPatch.
int sinddm_warp_whole_bwd(const void* ct, const void* coords, void* gimg, int B, int H, int W,
                          int C, int N, int frame_w, int patch_w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(gimg, 0, (size_t)B * H * W * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N == 0) return 0;
  int pw_log2 = 5;
  while (pw_log2 < sinddm::kPatchLog2 && (1 << pw_log2) < patch_w) ++pw_log2;
  if (frame_w <= 0 || N % frame_w != 0 || patch_w != (1 << pw_log2)) return (int)cudaErrorInvalidValue;
  const int rows_a_patch = sinddm::kPatch / patch_w;
  const int col_tiles = (frame_w + patch_w - 1) / patch_w;
  const int tiles = (N / frame_w + rows_a_patch - 1) / rows_a_patch * col_tiles;
  const auto kernel = C == 3 ? &sinddm::warp_whole_bwd_kernel<3> : &sinddm::warp_whole_bwd_kernel<0>;
  kernel<<<B * tiles, sinddm::kPatchThreads, 0, s>>>(
      static_cast<const float*>(ct), static_cast<const float2*>(coords), static_cast<float*>(gimg), H,
      W, C, N, frame_w, pw_log2, col_tiles, tiles);
  return (int)cudaGetLastError();
}

// img [B,H,W,C], coords [B,N,2] (8-byte aligned) -> out [B,N,C]; B*N*C < 2^31.
int sinddm_warp_win_fwd(const void* img, const void* coords, void* out, float fill, int B, int H,
                        int W, int C, int N, int device, void* stream) {
  return sinddm::launch_run_fwd<sinddm::Order::kYFirst>(img, coords, out, fill, B, H, W, C, N, device, stream);
}

// As sinddm_warp_win_fwd, columns first.
int sinddm_warp_winx_fwd(const void* img, const void* coords, void* out, float fill, int B, int H,
                         int W, int C, int N, int device, void* stream) {
  return sinddm::launch_run_fwd<sinddm::Order::kXFirst>(img, coords, out, fill, B, H, W, C, N, device, stream);
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

// As sinddm_warp_winx_fwd; the fp32 image is split into its bf16 parts in the kernel.
int sinddm_warp_win3_fwd(const void* img, const void* coords, void* out, float fill, int B, int H,
                         int W, int C, int N, int device, void* stream) {
  return sinddm::launch_run_fwd<sinddm::Order::kSplit3>(img, coords, out, fill, B, H, W, C, N, device, stream);
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
