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
// 3.0 G FMA (0.09 ms at the 67 TFLOP/s fp32 rate). So every input element
// should cross from L2 to an SM about once, and the SM's work per byte must
// stay small enough to keep the stream going. Where C * sizeof(T) % 16 == 0
// and the pointers are 16-byte aligned (C = 80 and 160 on the sampling path),
// dw5x5_ring_kernel does that as a rolling-row stencil:
//   * a block of 128 threads owns a strip of 32 output columns x a slab of
//     32 channels (128 bytes fp32, 64 bf16) and walks down a segment of rows;
//   * input rows of 36 pixels x the slab enter a ring in shared memory by
//     16-byte cp.async.cg, kAhead rows in flight ahead of the row being read
//     (a copy outside the image has source size 0 and fills zeros);
//   * a thread takes 2 channels x kCols neighbouring columns and reads each
//     input row once: kCols + 4 loads from the ring feed the partial sums of
//     the five output rows that row touches, which live in registers (5 x
//     kCols x 2), so the ring holds only the row being read and those in
//     flight, and each tap is read from shared memory 1.5 times, not 25;
//   * the slab's 25 weight pairs, its bias and vec sit in registers, loaded
//     once a block (127-128 registers, 4 blocks an SM);
//   * a warp's stores cover whole slabs of pixel rows.
// A slab of 128 bytes is a whole line of each pixel: 64-byte slabs (16 fp32
// channels) read half lines and took 1.22x as long at [16,186,248,160] on an
// H100 (PERF.md). Segments are cut from the shape so that the blocks' waves
// x rows are fewest (dw_plan in ops/dw_conv.py holds the same arithmetic).
// Other shapes (l1's C = 3, or a misaligned view) take dw5x5_kernel, one
// output a thread, a warp across 32 channels.
//
// Each output sums its 25 taps in the same order in both kernels (rows, then
// columns, then + bias, then + vec), so they agree bit for bit: a row or
// column outside the image adds fmaf(0, w, acc), which is acc itself.
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

// Two consecutive channels as one load / store.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kCols = 4;       // output columns a thread
constexpr int kGroups = 8;     // column groups a block
constexpr int kAhead = 2;      // input rows in flight ahead of the one being read (4 measured slower)
constexpr int kRingRows = kAhead + 1;
constexpr int kSmThreads = 512;  // threads an SM: 128 registers a thread fill its register file
constexpr int kSms = 132;        // an H100 SXM's
constexpr int kMinRows = 8;      // the fewest rows a segment is cut to

template <typename T>
struct Ring {
  static constexpr int kSlab = 32;                          // channels a block
  static constexpr int kSlabBytes = kSlab * sizeof(T);      // 128 fp32, 64 bf16
  static constexpr int kChunks = kSlab / 2;                 // threads across a slab, 2 channels each
  static constexpr int kThreads = kChunks * kGroups;
  static constexpr int kStrip = kGroups * kCols;            // output columns a block
  static constexpr int kRowPx = kStrip + 4;
  // a staged pixel: a 64-byte slab is padded to 80 bytes, so that the two
  // column groups of a warp read other banks (a 128-byte one fills a warp's
  // half-wavefront alone)
  static constexpr int kPxBytes = kSlabBytes % 128 == 0 ? kSlabBytes : kSlabBytes + 16;
  static constexpr int kPx = kPxBytes / sizeof(T);
  static constexpr int kUnits = kSlabBytes / 16;            // 16-byte copies a staged pixel
  static constexpr int kRowElems = kRowPx * kPx;
};

// The same function for C * sizeof(T) % 16 == 0 and 16-byte aligned
// pointers. Block (((b * segs + seg) * strips + strip) * slabs + slab) takes
// output rows [seg * seg_rows, +seg_rows) x columns [strip * kStrip, +kStrip)
// x channels [slab * kSlab, +kSlab), clipped to the tensor; it reads input
// rows from 2 above to 2 below its rows. Each output sums its taps in the
// scalar kernel's order.
template <typename T>
__global__ void __launch_bounds__(Ring<T>::kThreads, kSmThreads / Ring<T>::kThreads)
dw5x5_ring_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                  const T* __restrict__ vec, T* __restrict__ out, int H, int W, int C, int slabs,
                  int strips, int seg_rows, int segs) {
  using R = Ring<T>;
  __shared__ __align__(16) unsigned char ring_bytes[kRingRows * R::kRowElems * sizeof(T)];
  T* ring = reinterpret_cast<T*>(ring_bytes);
  int blk = blockIdx.x;
  const int slab = blk % slabs;
  blk /= slabs;
  const int strip = blk % strips;
  blk /= strips;
  const int seg = blk % segs;
  const int b = blk / segs;
  const int c0 = slab * R::kSlab, x0 = strip * R::kStrip, y0 = seg * seg_rows;
  const int y1 = min(H, y0 + seg_rows);
  const int n_in = y1 - y0 + 4;  // input rows y0 - 2 .. y1 + 1
  const int slab_units = min(R::kSlab, C - c0) * (int)sizeof(T) / 16;

  // input row y0 - 2 + t into ring slot `slot`, one commit group a row (an
  // empty one past the segment, so that every step waits on the same count)
  const int unit = threadIdx.x % R::kUnits;
  const T* src0 = x + b * H * W * C + c0 + unit * (16 / (int)sizeof(T));
  const auto stage = [&](int t, int slot) {
    if (t < n_in && unit < slab_units) {
      const int r = y0 - 2 + t;
      const bool row_in = r >= 0 && r < H;
      T* dst = ring + slot * R::kRowElems + unit * (16 / (int)sizeof(T));
      for (int px = threadIdx.x / R::kUnits; px < R::kRowPx; px += R::kThreads / R::kUnits) {
        const int col = x0 - 2 + px;
        const bool in = row_in && col >= 0 && col < W;
        cp_async16(dst + px * R::kPx, in ? src0 + (r * W + col) * C : x, in);
      }
    }
    cp_async_commit();
  };

  const int k = threadIdx.x % R::kChunks, g = threadIdx.x / R::kChunks;
  const int c = c0 + 2 * k;
  const bool active = c < C;  // the last slab of a C that is not a multiple of kSlab
  float wv[25][2] = {}, bv[2] = {}, vv[2] = {};
  if (active) {
#pragma unroll
    for (int i = 0; i < 25; ++i) {
      const float2 q = load2(w + i * C + c);
      wv[i][0] = q.x, wv[i][1] = q.y;
    }
    const float2 q = load2(bias + c);
    bv[0] = q.x, bv[1] = q.y;
    if (vec != nullptr) {
      const float2 v = load2(vec + b * C + c);
      vv[0] = v.x, vv[1] = v.y;
    }
  }
  const int xo = x0 + g * kCols;  // the thread's first output column
  const T* taps = ring + g * kCols * R::kPx + 2 * k;
  T* dst = out + xo * C + c;

  for (int t = 0; t < kAhead; ++t) stage(t, t);
  // partial sums of the output rows the current input row touches: output
  // row y0 + i in acc[i % 5]
  float acc[5][kCols][2] = {};
  int slot = 0;  // ring slot of input row t
  for (int t0 = 0; t0 < n_in; t0 += 5) {
#pragma unroll
    for (int u = 0; u < 5; ++u) {  // input row t = t0 + u touches output rows y0 + t - di, di = 0..4
      const int t = t0 + u;
      if (t >= n_in) break;
      cp_async_wait<kAhead - 1>();  // this thread's copies of row t have landed
      __syncthreads();              // everyone's have, and row t - 1's slot is free
      stage(t + kAhead, slot == 0 ? kRingRows - 1 : slot - 1);
      if (active) {
        const T* row = taps + slot * R::kRowElems;
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[u][j][0] = acc[u][j][1] = 0.f;  // output row y0 + t begins
#pragma unroll
        for (int col = 0; col < kCols + 4; ++col) {
          const float2 v = load2(row + col * R::kPx);
#pragma unroll
          for (int dj = 0; dj < 5; ++dj) {
            const int j = col - dj;
            if (j < 0 || j >= kCols) continue;
#pragma unroll
            for (int di = 0; di < 5; ++di) {
              float* a = acc[(u - di + 5) % 5][j];
              a[0] = fmaf(v.x, wv[di * 5 + dj][0], a[0]);
              a[1] = fmaf(v.y, wv[di * 5 + dj][1], a[1]);
            }
          }
        }
        if (t >= 4) {  // output row y0 + t - 4 has its five rows: bias, vec, store
          const float(&a)[kCols][2] = acc[(u + 1) % 5];
          T* o = dst + (b * H + y0 + t - 4) * W * C;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if (xo + j >= W) break;
            const float s0 = a[j][0] + bv[0], s1 = a[j][1] + bv[1];
            if (vec != nullptr) {
              store2(o + j * C, s0 + vv[0], s1 + vv[1]);
            } else {
              store2(o + j * C, s0, s1);
            }
          }
        }
      }
      slot = slot == kRingRows - 1 ? 0 : slot + 1;
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int dw5x5(const void* x, const void* w, const void* bias, const void* vec, void* out, int B,
          int H, int W, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const T *xt = static_cast<const T*>(x), *wt = static_cast<const T*>(w);
  const T *bt = static_cast<const T*>(bias), *vt = static_cast<const T*>(vec);
  T* ot = static_cast<T*>(out);
  if (C * sizeof(T) % 16 == 0 && aligned16(x) && aligned16(w) && aligned16(bias) && aligned16(out) &&
      (vec == nullptr || aligned16(vec))) {
    using R = Ring<T>;
    const int slabs = cdiv(C, R::kSlab), strips = cdiv(W, R::kStrip);
    const int base = B * slabs * strips;
    // A block's time goes with its input rows, and the blocks run in waves
    // of kSms * (kSmThreads / kThreads): cut the rows into the segments
    // that take the fewest waves x rows a block (the fewest segments of equals).
    const long long slots = (long long)kSms * (kSmThreads / R::kThreads);
    int seg_rows = H;
    long long best = -1;
    for (int n = 1; n <= cdiv(H, kMinRows); ++n) {
      const int rows = cdiv(H, n);
      const long long cost = ((long long)base * cdiv(H, rows) + slots - 1) / slots * (rows + 4);
      if (best < 0 || cost < best) best = cost, seg_rows = rows;
    }
    const int segs = cdiv(H, seg_rows);
    dw5x5_ring_kernel<T><<<base * segs, R::kThreads, 0, s>>>(xt, wt, bt, vt, ot, H, W, C, slabs, strips,
                                                             seg_rows, segs);
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
