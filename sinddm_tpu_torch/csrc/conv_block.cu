// The SinDDM conv block on Hopper, NHWC, fp32 accumulation:
//
//   h1  = dw5x5(x) + bdw + cond[b]                 zero outside the image
//   g   = gelu(conv3x3(h1, W1) + b1)               zero outside the image
//   out = conv3x3(g, W2) + b2 + (x @ Wres + bres | x)
//
// Replaces the TPU kernel sinddm_tpu/ops/pallas_conv.py `_conv_block_kernel`
// (entry `fused_conv_block`). That kernel was shaped by VMEM, 128-lane DMA
// and the MXU; this one runs the two 3x3 stages on the SM's tensor cores
// with warp-level `mma.sync`, fed from shared memory by `cp.async`.
//
// What bounds it on the H100: operations on the tensor cores. At the finest
// balloons shape (16x186x248) the 160->160 block is 686 GFLOP against
// 0.94 GB of input plus output, ~730 FLOP per byte.
//   * fp32 runs 3xTF32: each operand is split in registers as its fragment
//     is loaded, hi = rna(a), lo = rna(a - hi) with cvt.rna.tf32's rounding
//     (`tf32_rna`), and each product is lo*hi + hi*lo + hi*hi (small terms
//     first; lo*lo dropped) into fp32 accumulators: three TF32 products, so
//     its bound is 3x the TF32 rate (~4.16 ms for that block at 495
//     TFLOP/s). The tensor cores truncate as they accumulate, so a chunk's
//     products go into partial sums that fp32 adds fold into the running
//     ones (`mma_chunk`): 20x smaller errors than one running sum, for 4-8%
//     of the time. Single-pass TF32 keeps 11 bits of each operand; over
//     K = 9*160 = 1440 terms it leaves the fp32 block's atol 2e-4 + rtol
//     2e-4 by ~5x, and it would compute another function than the JAX
//     package's fp32 block.
//   * bf16 runs mma.m16n8k16 bf16 x bf16 -> fp32 (0.69 ms bound).
//
// Implicit GEMM. A block owns an 8x16-pixel (M 128) x 80-channel (N) output
// tile of one image (Co = 160: two tiles). Its K loop walks chunks of 32
// bytes of input channels (8 fp32 = one k8 step, 16 bf16 = one k16 step);
// the 9 taps of a chunk read one staged (8+2)x(16+2) halo tile at shifted
// offsets. Each of the 4 warps owns 2 output rows x 80 channels: two m16 by
// ten n8 fragments, 80 fp32 accumulators a thread. For the 1x1 projection
// (l1, l2, l4) the un-haloed x tile and Wres run as extra K chunks of the
// same loop, one tap each, split the same way in fp32.
//
// The ring: 2 stages of 33,984 bytes in dynamic shared memory (67,968 in
// all; at 236-255 registers a thread, 2 blocks an SM): the halo tile, 180
// pixels at a 48-byte stride, and the 9 x chunk x 80 weight slab at an
// 88-element row stride. Both strides put the eight rows of a fragment load
// in distinct banks. Chunk k+1 loads while chunk k multiplies
// (commit_group / wait_group); a third stage measured 3-4% slower. Two
// staging paths, chosen per tensor on the host:
//   * 16-byte `cp.async.cg` copies where the channel count is a multiple of
//     4 (fp32) / 8 (bf16) and the base is 16-byte aligned; pixels outside
//     the image and channels past C use the zero-fill form (src-size 0),
//     which gives the TPU kernel's `valid1`/`valid2` zero padding;
//   * plain loads and shared stores otherwise (l1's C = 3, odd widths,
//     misaligned views), zero-padding K and N the same way.
// The epilogue adds the bias, then takes the exact erf GELU (conv1) or adds
// the identity residual or the projection's bres, and stores masked on
// ragged H, W and Co.
//
// Three launches per block: h1 (dw+bias+cond) is the kernel of dw_conv.cu;
// this file holds conv1+bias+GELU and conv2+bias+residual. The split costs
// two extra device-memory round trips, h1 and g each written once and read
// once: 2*B*H*W*(C+Co)*sizeof(T) bytes, 1.89 GB for the fp32 160->160 block
// at the finest shape (0.56 ms at 3.35 TB/s).
//
// fp32 on `wgmma` (`conv3x3_tc_kernel_sm90`, below): where the 3x3 input's
// channel count and Co are multiples of 8 (`ops/conv_block.py`
// `wgmma_route`; in the walk every stage but l1's conv1), the fp32 stages
// run as warpgroup `wgmma.m64n80k8` TF32 products with the same 3xTF32
// split, products in the same order and the same per-chunk partial sums:
// A (the activations) split in registers as above, B (the weights) read by
// descriptor from shared memory, split into TF32 hi / lo and laid out
// K-major on the host once per weight version (`split_weights`), which
// removes the re-layout that TF32 `wgmma`'s K-major operands need. Its
// outputs have equalled this kernel's bit for bit on every shape compared
// on the card. What bounds it: the tensor cores at 3x the TF32 rate, of
// which it reaches ~0.6 in the l3 stages at the finest shape and 0.52 over
// the walk (PERF.md §5-6). Left on `mma.sync`: bf16; l1's conv1, whose
// 3-channel h1 (12 bytes a pixel) gives neither 16-byte copies nor a K
// chunk; the tested odd shapes (C = 12, 90, Co = 100). TMA with tensor maps
// is not used: the weights come by one bulk copy a chunk, the halo and x by
// `cp.async` (x at any alignment and C). Fusing the three launches is next.
//
// Types: T = float, or __nv_bfloat16 with fp32 accumulation. In bf16 the
// intermediates h1 and g are rounded to bf16 before each product, as the TPU
// kernel rounds them to the input type; bf16 x bf16 products are exact in fp32.
//
// C interface, loaded with ctypes: every entry returns the first non-zero
// cudaError_t of its launches (0 on success) and never synchronises. A block
// is its two stage entries called in turn; the denoiser's valid-mask mode
// zeroes g outside the valid region in between.
#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace sinddm {

constexpr int kTH = 8;                               // output rows per block
constexpr int kTW = 16;                              // output cols per block (one m16 fragment)
constexpr int kTN = 80;                              // output channels per block
constexpr int kWarps = 4;                            // a warp: 2 rows x 80 channels
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = kTH / kWarps;                    // m16 fragments a warp (2)
constexpr int kNT = kTN / 8;                         // n8 fragments a warp (10)
constexpr int kInH = kTH + 2;
constexpr int kInW = kTW + 2;
constexpr int kHalo = kInH * kInW;                   // 180 pixels
constexpr int kStages = 2;
constexpr int kChunkBytes = 32;                      // input channels a chunk, in bytes
constexpr int kPixBytes = 48;                        // a staged pixel: 32 bytes + 16 of padding
constexpr int kWStride = kTN + 8;                    // a staged weight row, in elements
constexpr int kHaloBytes = kHalo * kPixBytes;        // 8,640
constexpr int kSlabBytes = 9 * kChunkBytes * kWStride;  // 25,344 (9 x KC rows x 88 x sizeof(T))
constexpr int kStageBytes = kHaloBytes + kSlabBytes;    // 33,984
constexpr int kSmemBytes = kStages * kStageBytes;       // 67,968

enum Epilogue { kGelu = 0, kIdentityRes = 1, kProjRes = 2 };

template <typename T>
struct ConvArgs {
  const T* in;     // [B,H,W,Cin]
  const T* w;      // [3,3,Cin,Co]
  const T* bias;   // [Co]
  const T* res;    // [B,H,W,Cres]
  const T* wres;   // [Cres,Co]  (kProjRes)
  const T* bres;   // [Co]       (kProjRes)
  T* out;          // [B,H,W,Co]
  int Cin, Cres, H, W, Co, tiles_w;
  bool vec_in, vec_w, vec_res, vec_wres;  // 16-byte copies allowed
};

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage input channels k0 .. k0 + KC of the K loop into one ring slot:
// the 3x3 product's halo tile and 9-tap slab, or (PROJ) the projection's x
// tile at the halo's interior and one-tap slab of Wres.
template <bool PROJ, typename T>
__device__ __forceinline__ void stage_chunk(const ConvArgs<T>& a, unsigned char* slot, int k0,
                                            int b, int y0, int x0, int n0, int tid) {
  constexpr int KC = kChunkBytes / (int)sizeof(T);   // 8 fp32, 16 bf16
  constexpr int VEC = 16 / (int)sizeof(T);           // elements a 16-byte copy
  constexpr int PS = kPixBytes / (int)sizeof(T);     // staged pixel stride
  constexpr int pad = PROJ ? 1 : 0;                  // where the tile's (0, 0) sits in the halo
  constexpr int rows = PROJ ? kTH : kInH, cols = PROJ ? kTW : kInW;
  T* s_in = reinterpret_cast<T*>(slot);
  T* s_w = reinterpret_cast<T*>(slot + kHaloBytes);
  const T* src = PROJ ? a.res : a.in;
  const T* wsrc = PROJ ? a.wres : a.w;
  const int C = PROJ ? a.Cres : a.Cin;
  const int oy = y0 - 1 + pad, ox = x0 - 1 + pad;     // image origin of staged pixel (0, 0)
  const T* src_b = src + (size_t)b * a.H * a.W * C;
  const T zero = from_f32<T>(0.f);

  if (PROJ ? a.vec_res : a.vec_in) {
    for (int e = tid; e < rows * cols * (KC / VEC); e += kThreads) {
      const int p = e / (KC / VEC), part = e % (KC / VEC);
      const int py = p / cols, px = p - py * cols;
      const int gy = oy + py, gx = ox + px, k = k0 + part * VEC;
      const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && k < C;
      const T* g = ok ? src_b + ((size_t)gy * a.W + gx) * C + k : src;
      cp_async16(s_in + ((py + pad) * kInW + px + pad) * PS + part * VEC, g, ok);
    }
  } else {
    for (int e = tid; e < rows * cols * KC; e += kThreads) {
      const int p = e / KC, ci = e % KC;
      const int py = p / cols, px = p - py * cols;
      const int gy = oy + py, gx = ox + px, k = k0 + ci;
      const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && k < C;
      s_in[((py + pad) * kInW + px + pad) * PS + ci] =
          ok ? src_b[((size_t)gy * a.W + gx) * C + k] : zero;
    }
  }

  constexpr int n_rows = (PROJ ? 1 : 9) * KC;         // slab rows (tap, channel)
  if (PROJ ? a.vec_wres : a.vec_w) {
    constexpr int kPieces = kTN / VEC;
    for (int e = tid; e < n_rows * kPieces; e += kThreads) {
      const int row = e / kPieces, piece = e - row * kPieces;
      const int t = row / KC, k = k0 + row % KC, co = n0 + piece * VEC;
      const bool ok = k < C && co < a.Co;
      const T* g = ok ? wsrc + ((size_t)t * C + k) * a.Co + co : wsrc;
      cp_async16(s_w + row * kWStride + piece * VEC, g, ok);
    }
  } else {
    for (int e = tid; e < n_rows * kTN; e += kThreads) {
      const int row = e / kTN, n = e - row * kTN;
      const int t = row / KC, k = k0 + row % KC, co = n0 + n;
      s_w[row * kWStride + n] =
          (k < C && co < a.Co) ? wsrc[((size_t)t * C + k) * a.Co + co] : zero;
    }
  }
}

// fp32 -> TF32 rounded to nearest, ties away from zero: cvt.rna.tf32.f32's
// rounding, by adding half a TF32 unit to the sign-magnitude pattern and
// clearing the 13 bits below it. Written out, because ptxas wraps cvt.rna
// in an Inf/NaN select that costs two more instructions a value.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// The products of one staged chunk: NTAPS = 9 (3x3, tap t at offset
// (t / 3, t % 3) of the halo) or 1 (projection, the interior at (1, 1)).
// Fragment layouts are the PTX ISA's for m16n8k8 / m16n8k16: g = lane / 4
// picks the fragment row (pixel) and B column (channel), q = lane % 4 the k.
//
// fp32: the tensor cores add into their fp32 accumulator with truncation,
// so 540 mma into one sum (K = 1440, three products each) drift; the
// chunk's 27 (9 taps x 3) go into partial sums that start at zero, and
// those are added to the running sums with IEEE fp32 adds.
template <int NTAPS>
__device__ __forceinline__ void mma_chunk(const float* s_in, const float* s_w,
                                          float (&acc)[kMT][kNT][4], int warp, int lane) {
  constexpr int PS = kPixBytes / 4;
  const int g = lane >> 2, q = lane & 3;
  float part[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) {
    const int dy = NTAPS == 1 ? 1 : t / 3, dx = NTAPS == 1 ? 1 : t % 3;
    uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* p = s_in + ((kMT * warp + mt + dy) * kInW + dx + g) * PS + q;
      split_tf32(p[0], ahi[mt][0], alo[mt][0]);            // pixel g,     k q
      split_tf32(p[8 * PS], ahi[mt][1], alo[mt][1]);       // pixel g + 8, k q
      split_tf32(p[4], ahi[mt][2], alo[mt][2]);            // pixel g,     k q + 4
      split_tf32(p[8 * PS + 4], ahi[mt][3], alo[mt][3]);   // pixel g + 8, k q + 4
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float* p = s_w + (t * 8 + q) * kWStride + nt * 8 + g;
      uint32_t bhi[2], blo[2];
      split_tf32(p[0], bhi[0], blo[0]);               // k q,     n g
      split_tf32(p[4 * kWStride], bhi[1], blo[1]);    // k q + 4, n g
      // small terms first
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_tf32(part[mt][nt], alo[mt], bhi[0], bhi[1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_tf32(part[mt][nt], ahi[mt], blo[0], blo[1]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) mma_tf32(part[mt][nt], ahi[mt], bhi[0], bhi[1]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

template <int NTAPS>
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* s_in, const __nv_bfloat16* s_w,
                                          float (&acc)[kMT][kNT][4], int warp, int lane) {
  constexpr int PW = kPixBytes / 4;  // staged pixel stride in 32-bit words (two channels each)
  const int g = lane >> 2, q = lane & 3;
  const uint32_t* in_w = reinterpret_cast<const uint32_t*>(s_in);
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) {
    const int dy = NTAPS == 1 ? 1 : t / 3, dx = NTAPS == 1 ? 1 : t % 3;
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const uint32_t* p = in_w + ((kMT * warp + mt + dy) * kInW + dx + g) * PW + q;
      a[mt][0] = p[0];           // pixel g,     k 2q, 2q+1
      a[mt][1] = p[8 * PW];      // pixel g + 8, k 2q, 2q+1
      a[mt][2] = p[4];           // pixel g,     k 2q+8, 2q+9
      a[mt][3] = p[8 * PW + 4];  // pixel g + 8, k 2q+8, 2q+9
    }
    // B fragments of n8 tiles 2j and 2j+1 in one transposing load: lane l
    // gives the address of row k = l % 8 + 8 * (l / 8 % 2) of tile 2j + l / 16
    const __nv_bfloat16* row = s_w + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kWStride +
                               (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + j * 16);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_bf16(acc[mt][2 * j], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * j + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// out = epilogue(conv3x3_same(in, w) + bias); for kProjRes the 1x1
// projection of `res` runs as extra K chunks into the same accumulators.
template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads) conv3x3_tc_kernel(const ConvArgs<T> a) {
  constexpr int KC = kChunkBytes / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int y0 = (blockIdx.x / a.tiles_w) * kTH;
  const int x0 = (blockIdx.x % a.tiles_w) * kTW;
  const int n0 = blockIdx.y * kTN;
  const int b = blockIdx.z;
  const int n_main = (a.Cin + KC - 1) / KC;
  const int n_chunks = n_main + (EPI == kProjRes ? (a.Cres + KC - 1) / KC : 0);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // chunks below n_main are the 3x3 product's, the rest the projection's
  const auto stage = [&](int chunk) {
    unsigned char* slot = smem + (chunk % kStages) * kStageBytes;
    if (EPI != kProjRes || chunk < n_main)
      stage_chunk<false>(a, slot, chunk * KC, b, y0, x0, n0, tid);
    else
      stage_chunk<true>(a, slot, (chunk - n_main) * KC, b, y0, x0, n0, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) stage(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk i have landed
    __syncthreads();               // everyone's have, and slot (i - 1) % kStages is free
    if (i + kStages - 1 < n_chunks) stage(i + kStages - 1);
    cp_async_commit();
    const unsigned char* slot = smem + (i % kStages) * kStageBytes;
    const T* s_in = reinterpret_cast<const T*>(slot);
    const T* s_w = reinterpret_cast<const T*>(slot + kHaloBytes);
    if (EPI != kProjRes || i < n_main)
      mma_chunk<9>(s_in, s_w, acc, warp, lane);
    else
      mma_chunk<1>(s_in, s_w, acc, warp, lane);
  }
  cp_async_wait<0>();

  // accumulator i of fragment (mt, nt): pixel g + 8 * (i / 2), channel 2q + i % 2
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int gy = y0 + kMT * warp + mt;
    if (gy >= a.H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + 8 * half;
      if (gx >= a.W) continue;
      const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = n0 + nt * 8 + 2 * q + j;
          if (co < a.Co) {
            float v = acc[mt][nt][2 * half + j] + to_f32(a.bias[co]);
            if constexpr (EPI == kGelu) v = gelu_exact(v);
            if constexpr (EPI == kIdentityRes) v += to_f32(a.res[pix * a.Cres + co]);
            if constexpr (EPI == kProjRes) v += to_f32(a.bres[co]);
            a.out[pix * a.Co + co] = from_f32<T>(v);
          }
        }
      }
    }
  }
}

// 16-byte copies take a tensor whose rows of `c` elements start 16-byte aligned
template <typename T>
bool vec16(const T* p, int c) {
  return c % (16 / (int)sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

namespace {
// A bit a device for each instantiation ([bf16][EPI]) once its ring is
// allowed. Internal linkage: a static inside the template would be one
// symbol shared by every library that instantiates it.
std::atomic<unsigned long long> smem_allowed[2][3];
}  // namespace

template <typename T, int EPI>
cudaError_t launch_conv3x3(ConvArgs<T> a, int B, int device, cudaStream_t stream) {
  // the ring is above 48 KB: allow it once per instantiation and device
  std::atomic<unsigned long long>& allowed = smem_allowed[sizeof(T) == 2][EPI];
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(allowed.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_tc_kernel<T, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  a.tiles_w = (a.W + kTW - 1) / kTW;
  a.vec_in = vec16(a.in, a.Cin);
  a.vec_w = vec16(a.w, a.Co);
  a.vec_res = vec16(a.res, a.Cres);
  a.vec_wres = vec16(a.wres, a.Co);
  const int tiles_h = (a.H + kTH - 1) / kTH;
  const dim3 grid(a.tiles_w * tiles_h, (a.Co + kTN - 1) / kTN, B);
  conv3x3_tc_kernel<T, EPI><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// conv1 + bias + GELU: h1 [B,H,W,C] -> g [B,H,W,Co]
template <typename T>
int conv_stage1(const void* h1_, const void* w1_, const void* b1_, void* g_, int B, int H, int W,
                int C, int Co, int device, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ConvArgs<T> a{};
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.in = static_cast<const T*>(h1_);
  a.Cin = C;
  a.w = static_cast<const T*>(w1_);
  a.bias = static_cast<const T*>(b1_);
  a.out = static_cast<T*>(g_);
  return (int)launch_conv3x3<T, kGelu>(a, B, device, static_cast<cudaStream_t>(stream_));
}

// conv2 + bias + residual: g [B,H,W,Co] -> out, the residual from x [B,H,W,C]
template <typename T>
int conv_stage2(const void* g_, const void* w2_, const void* b2_, const void* x_,
                const void* wres_, const void* bres_, void* out_, int B, int H, int W, int C,
                int Co, int device, void* stream_) {
  const auto stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ConvArgs<T> a{};
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.in = static_cast<const T*>(g_);
  a.Cin = Co;
  a.w = static_cast<const T*>(w2_);
  a.bias = static_cast<const T*>(b2_);
  a.res = static_cast<const T*>(x_);
  a.Cres = C;
  a.out = static_cast<T*>(out_);
  if (wres_ == nullptr) return (int)launch_conv3x3<T, kIdentityRes>(a, B, device, stream);
  a.wres = static_cast<const T*>(wres_);
  a.bres = static_cast<const T*>(bres_);
  return (int)launch_conv3x3<T, kProjRes>(a, B, device, stream);
}

// ---- fp32 stages on Hopper wgmma -------------------------------------------
//
// The same two stages in fp32, for 3x3 inputs and outputs whose channel
// counts are multiples of 8 (`ops/conv_block.py` `wgmma_route`): the K loop's
// chunks stay 8 channels, the halo tile and the 9 taps as above, but the
// products are warpgroup `wgmma.m64n80k8` with A (the activations) split
// into TF32 hi / lo in registers and B (the weights) read from shared memory
// through descriptors, already split on the host into hi / lo and laid out
// K-major (`split_weights`, once per weight version).
//
// A block owns a 256-pixel (M) x 80-channel (N) tile, 16x16 or 8x32,
// whichever pads the image less (`wg::Tile`): two warpgroups of 8 rows x 16
// columns, each two m64 tiles (a warp: one output row of 16 pixels in
// each). A thread holds 2 x 40 running sums and 2 x 40 partial
// sums and three sets of A fragments (228-249 registers), so one block an
// SM. A stage of the ring is a chunk's 9 taps of hi / lo slabs (46,080 B,
// contiguous in the split weights: one `cp.async.bulk` by one thread,
// completed on the stage's mbarrier) and its halo at the 48-byte pixel
// stride ((16+2)x(16+2) or (8+2)x(32+2) pixels, 16,320 B at most, `cp.async`
// by every thread); three stages, 187,224 B with the barriers. Measured on
// the H100 (PERF.md §6), with parts knocked out: the weights' copies cost
// ~9%, the halo's ~10%; the per-tap A fragments, the fold and the barrier
// nothing visible; a persistent grid was slower. The rest is not pinned
// down; the card, at its 700 W limit, runs 1.75-1.9 GHz under this load.
namespace wg {
constexpr int kTN = 80;                              // output channels a block
constexpr int kGroups = 2;                           // warpgroups, 8 rows each
constexpr int kThreads = 128 * kGroups;
constexpr int kMT = 2;                               // m64 tiles a warpgroup
constexpr int kAcc = kTN / 2;                        // accumulators a thread an m64 tile
constexpr int kPS = 12;                              // staged pixel stride in floats (48 bytes)
constexpr int kHaloBytes = 10 * 34 * kPS * 4;        // 16,320: the larger halo, (8+2)x(32+2)
constexpr int kSlab = kTN * 8;                       // floats of one tap's hi or lo slab
constexpr int kSlabBytes = kSlab * 4;                // 2,560
constexpr int kChunkWBytes = 9 * 2 * kSlabBytes;     // 46,080
constexpr int kStageBytes = kChunkWBytes + kHaloBytes;  // 62,400
constexpr int kStages = 3;
constexpr int kRingBytes = kStages * kStageBytes;    // 187,200
constexpr int kSmemBytes = kRingBytes + 8 * kStages; // + a full barrier a stage

// The output tile, 256 pixels: TW = 16, 16x16, the warpgroups one above
// the other; TW = 32, 8x32, side by side. Its halo, (TH+2)x(TW+2).
template <int TW>
struct Tile {
  static constexpr int TH = 256 / TW, InH = TH + 2, InW = TW + 2;
  // the warpgroup's first output row and column in the tile
  static __device__ __forceinline__ int row(int wg) { return TW == 16 ? 8 * wg : 0; }
  static __device__ __forceinline__ int col(int wg) { return TW == 16 ? 0 : 16 * wg; }
};
}  // namespace wg

struct WgArgs {
  const float* in;     // [B,H,W,Cin], Cin % 8 == 0, 16-byte aligned
  const float* w;      // split_weights(W): [ceil(Co/80)][Cin/8][9][2][80*8]
  const float* bias;   // [Co]
  const float* res;    // [B,H,W,Cres], any alignment
  const float* wres;   // split_weights(Wres): [ceil(Co/80)][ceil(Cres/8)][1][2][80*8] (kProjRes)
  const float* bres;   // [Co]  (kProjRes)
  float* out;          // [B,H,W,Co], Co % 8 == 0, 8-byte aligned
  int Cin, Cres, H, W, Co, tiles_w;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier `bar` expects `bytes` more, then a bulk copy of `bytes` from
// global to shared memory completes them on it (one thread issues both)
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// B's descriptor: a slab of 8-row x 16-byte core matrices, K-major without
// swizzle; the two k4 halves 128 bytes apart (leading), the n8 groups 256
// bytes apart (stride). Layout bits 62-63 zero: no swizzle.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators in place around wgmma: the compiler may not move
// a use of them across this point (a wait, or the first product).
__device__ __forceinline__ void fence_acc(float (&d)[wg::kMT][wg::kAcc]) {
#pragma unroll
  for (int mt = 0; mt < wg::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < wg::kAcc; ++i) asm volatile("" : "+f"(d[mt][i])::"memory");
}

// d (+)= A (64x8 TF32, registers) x B (8x80 TF32, shared memory); SCALE_D 0
// ignores d's old value.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_tf32(float (&d)[wg::kAcc], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// Stage chunk kc into a ring slot: its weight slabs (contiguous, 16-byte
// copies), and the halo tile of the 3x3 input (16-byte copies, zero-filled
// outside the image) or (PROJ) the x tile at the halo's interior (4-byte
// copies: any alignment, any C; zero past C).
template <bool PROJ, int TW>
__device__ __forceinline__ void wg_stage(const WgArgs& a, unsigned char* slot, uint64_t* bar,
                                         int kc, int b, int y0, int x0, int ntile, int tid) {
  constexpr int taps = PROJ ? 1 : 9;
  float* s_in = reinterpret_cast<float*>(slot + wg::kChunkWBytes);
  const int n_chunks = PROJ ? (a.Cres + 7) / 8 : a.Cin / 8;
  const float* wsrc =
      (PROJ ? a.wres : a.w) + ((size_t)ntile * n_chunks + kc) * taps * 2 * wg::kSlab;
  if (tid == 0) bulk_load(slot, wsrc, taps * 2 * wg::kSlabBytes, bar);
  if constexpr (!PROJ) {
    const float* src_b = a.in + (size_t)b * a.H * a.W * a.Cin + kc * 8;
    using S = wg::Tile<TW>;
    for (int e = tid; e < S::InH * S::InW * 2; e += wg::kThreads) {
      const int p = e >> 1, part = e & 1;
      const int py = p / S::InW, px = p - py * S::InW;
      const int gy = y0 - 1 + py, gx = x0 - 1 + px;
      const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      const float* g = ok ? src_b + ((size_t)gy * a.W + gx) * a.Cin + part * 4 : a.in;
      cp_async16(s_in + p * wg::kPS + part * 4, g, ok);
    }
  } else {
    const float* src_b = a.res + (size_t)b * a.H * a.W * a.Cres;
    for (int e = tid; e < 256 * 8; e += wg::kThreads) {
      const int p = e >> 3, ci = e & 7;
      const int py = p / TW, px = p - py * TW;
      const int gy = y0 + py, gx = x0 + px, k = kc * 8 + ci;
      const bool ok = gy < a.H && gx < a.W && k < a.Cres;
      const float* g = ok ? src_b + ((size_t)gy * a.W + gx) * a.Cres + k : a.res;
      cp_async4(s_in + ((py + 1) * (TW + 2) + px + 1) * wg::kPS + ci, g, ok);
    }
  }
}

// A's fragment of one m64 tile at tap (dy, dx), split: the warp's output
// row from column col, pixels g and g + 8, channels q and q + 4 (the
// m16n8k8 layout).
template <int TW>
__device__ __forceinline__ void wg_load_a(const float* s_in, int row, int col, int dy, int dx,
                                          int lane, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s_in + ((row + dy) * (TW + 2) + col + dx + g) * wg::kPS + q;
  split_tf32(p[0], hi[0], lo[0]);                       // pixel g,     k q
  split_tf32(p[8 * wg::kPS], hi[1], lo[1]);             // pixel g + 8, k q
  split_tf32(p[4], hi[2], lo[2]);                       // pixel g,     k q + 4
  split_tf32(p[8 * wg::kPS + 4], hi[3], lo[3]);         // pixel g + 8, k q + 4
}

// The products of one staged chunk (NTAPS = 9, or 1 for the projection at
// the halo's interior) into partial sums that start at zero, then folded
// into the running sums with fp32 adds, as mma_chunk does. A tap's A is
// loaded and split while the two taps before it multiply (three register
// sets; wait_group 2 frees the oldest).
template <int NTAPS, int TW>
__device__ __forceinline__ void wg_chunk(const unsigned char* slot, float (&acc)[wg::kMT][wg::kAcc],
                                         float (&part)[wg::kMT][wg::kAcc], int row0, int col0,
                                         int lane) {
  const float* s_in = reinterpret_cast<const float*>(slot + wg::kChunkWBytes);
  const uint32_t w0 = smem_u32(slot);
  uint32_t ahi[3][wg::kMT][4], alo[3][wg::kMT][4];
#pragma unroll
  for (int mt = 0; mt < wg::kMT; ++mt)
    wg_load_a<TW>(s_in, row0 + 4 * mt, col0, NTAPS == 1 ? 1 : 0, NTAPS == 1 ? 1 : 0, lane,
                  ahi[0][mt], alo[0][mt]);
  fence_acc(part);
#pragma unroll
  for (int t = 0; t < NTAPS; ++t) {
    const int cur = t % 3, next = (t + 1) % 3;
    const uint64_t bhi = wg_desc(w0 + (2 * t) * wg::kSlabBytes);
    const uint64_t blo = wg_desc(w0 + (2 * t + 1) * wg::kSlabBytes);
    wgmma_fence();
    // small terms first
#pragma unroll
    for (int mt = 0; mt < wg::kMT; ++mt) {
      if (t == 0)
        wgmma_tf32<0>(part[mt], alo[cur][mt], bhi);
      else
        wgmma_tf32<1>(part[mt], alo[cur][mt], bhi);
    }
#pragma unroll
    for (int mt = 0; mt < wg::kMT; ++mt) wgmma_tf32<1>(part[mt], ahi[cur][mt], blo);
#pragma unroll
    for (int mt = 0; mt < wg::kMT; ++mt) wgmma_tf32<1>(part[mt], ahi[cur][mt], bhi);
    wgmma_commit();
    if (t + 1 < NTAPS) {
      wgmma_wait<2>();  // tap t - 2's products are done with register set `next`
      const int dy = (t + 1) / 3, dx = (t + 1) % 3;
#pragma unroll
      for (int mt = 0; mt < wg::kMT; ++mt)
        wg_load_a<TW>(s_in, row0 + 4 * mt, col0, dy, dx, lane, ahi[next][mt], alo[next][mt]);
    }
  }
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int mt = 0; mt < wg::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < wg::kAcc; ++i) acc[mt][i] += part[mt][i];
}

// out = epilogue(conv3x3_same(in, W) + bias), fp32 through wgmma; for
// kProjRes the 1x1 projection of `res` runs as extra K chunks.
template <int EPI, int TW>
__global__ void __launch_bounds__(wg::kThreads, 1) conv3x3_tc_kernel_sm90(const WgArgs a) {
  using S = wg::Tile<TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int y0 = (blockIdx.x / a.tiles_w) * S::TH;
  const int x0 = (blockIdx.x % a.tiles_w) * TW;
  const int ntile = blockIdx.y, n0 = ntile * wg::kTN;
  const int b = blockIdx.z;
  // the warp's output row in the tile for m64 tile 0 (tile 1: 4 rows down),
  // and its warpgroup's first column
  const int row0 = S::row(tid >> 7) + ((tid >> 5) & 3), col0 = S::col(tid >> 7);
  const int n_main = a.Cin / 8;
  const int n_chunks = n_main + (EPI == kProjRes ? (a.Cres + 7) / 8 : 0);

  float acc[wg::kMT][wg::kAcc], part[wg::kMT][wg::kAcc];
#pragma unroll
  for (int mt = 0; mt < wg::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < wg::kAcc; ++i) acc[mt][i] = part[mt][i] = 0.f;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wg::kRingBytes);
  if (tid == 0) {
    for (int s = 0; s < wg::kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const auto stage = [&](int chunk) {
    const int s = chunk % wg::kStages;
    unsigned char* slot = smem + s * wg::kStageBytes;
    if (EPI != kProjRes || chunk < n_main)
      wg_stage<false, TW>(a, slot, full + s, chunk, b, y0, x0, ntile, tid);
    else
      wg_stage<true, TW>(a, slot, full + s, chunk - n_main, b, y0, x0, ntile, tid);
  };
#pragma unroll
  for (int s = 0; s < wg::kStages - 1; ++s) {
    if (s < n_chunks) stage(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<wg::kStages - 2>();  // this thread's copies of chunk i's tile have landed
    mbar_wait(full + i % wg::kStages, (i / wg::kStages) & 1);  // and its weights
    // everyone's have; slot (i - 1) % wg::kStages is free: every warpgroup
    // waited on its products
    __syncthreads();
    if (i + wg::kStages - 1 < n_chunks) stage(i + wg::kStages - 1);
    cp_async_commit();
    const unsigned char* slot = smem + (i % wg::kStages) * wg::kStageBytes;
    if (EPI != kProjRes || i < n_main)
      wg_chunk<9, TW>(slot, acc, part, row0, col0, lane);
    else
      wg_chunk<1, TW>(slot, acc, part, row0, col0, lane);
  }
  cp_async_wait<0>();

  // accumulator 4j + 2h + e of an m64 tile: pixel g + 8h of the warp's row,
  // channel 8j + 2q + e; Co % 8 == 0, so a pair is in or out together
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < wg::kMT; ++mt) {
    const int gy = y0 + row0 + 4 * mt;
    if (gy >= a.H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = x0 + col0 + g + 8 * h;
      if (gx >= a.W) continue;
      const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
#pragma unroll
      for (int j = 0; j < wg::kTN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * q;
        if (co >= a.Co) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[mt][4 * j + 2 * h + e] + a.bias[co + e];
          if constexpr (EPI == kGelu) v[e] = gelu_exact(v[e]);
          if constexpr (EPI == kIdentityRes) v[e] += a.res[pix * a.Cres + co + e];
          if constexpr (EPI == kProjRes) v[e] += a.bres[co + e];
        }
        *reinterpret_cast<float2*>(a.out + pix * a.Co + co) = make_float2(v[0], v[1]);
      }
    }
  }
}

namespace {
std::atomic<unsigned long long> smem_allowed_sm90[3][2];
}  // namespace

template <int EPI, int TW>
cudaError_t launch_sm90(WgArgs a, int B, int device, cudaStream_t stream) {
  std::atomic<unsigned long long>& allowed = smem_allowed_sm90[EPI][TW == 32];
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (!(allowed.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(conv3x3_tc_kernel_sm90<EPI, TW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 wg::kSmemBytes);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  a.tiles_w = (a.W + TW - 1) / TW;
  const int tiles_h = (a.H + wg::Tile<TW>::TH - 1) / wg::Tile<TW>::TH;
  const dim3 grid(a.tiles_w * tiles_h, (a.Co + wg::kTN - 1) / wg::kTN, B);
  conv3x3_tc_kernel_sm90<EPI, TW><<<grid, wg::kThreads, wg::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// The tile that pads the image least, 16x16 on a tie: 8x32 at the walk's
// 67x90 and 133x177, where 16 rows pad H by 19% and 8%.
template <int EPI>
cudaError_t launch_conv3x3_sm90(WgArgs a, int B, int device, cudaStream_t stream) {
  const auto misaligned = [](const void* p, int bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) != 0;
  };
  if (a.Cin % 8 != 0 || a.Co % 8 != 0 || misaligned(a.in, 16) || misaligned(a.w, 16) ||
      misaligned(a.out, 8) || (EPI == kProjRes && misaligned(a.wres, 16)))
    return cudaErrorInvalidValue;
  const auto padded = [&](int th, int tw) {
    return (long)((a.H + th - 1) / th * th) * ((a.W + tw - 1) / tw * tw);
  };
  if (padded(8, 32) < padded(16, 16)) return launch_sm90<EPI, 32>(a, B, device, stream);
  return launch_sm90<EPI, 16>(a, B, device, stream);
}

int conv_stage1_sm90(const void* h1_, const void* w1_, const void* b1_, void* g_, int B, int H,
                     int W, int C, int Co, int device, void* stream_) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WgArgs a{};
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.in = static_cast<const float*>(h1_);
  a.Cin = C;
  a.w = static_cast<const float*>(w1_);
  a.bias = static_cast<const float*>(b1_);
  a.out = static_cast<float*>(g_);
  return (int)launch_conv3x3_sm90<kGelu>(a, B, device, static_cast<cudaStream_t>(stream_));
}

int conv_stage2_sm90(const void* g_, const void* w2_, const void* b2_, const void* x_,
                     const void* wres_, const void* bres_, void* out_, int B, int H, int W, int C,
                     int Co, int device, void* stream_) {
  const auto stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WgArgs a{};
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.in = static_cast<const float*>(g_);
  a.Cin = Co;
  a.w = static_cast<const float*>(w2_);
  a.bias = static_cast<const float*>(b2_);
  a.res = static_cast<const float*>(x_);
  a.Cres = C;
  a.out = static_cast<float*>(out_);
  if (wres_ == nullptr) return (int)launch_conv3x3_sm90<kIdentityRes>(a, B, device, stream);
  a.wres = static_cast<const float*>(wres_);
  a.bres = static_cast<const float*>(bres_);
  return (int)launch_conv3x3_sm90<kProjRes>(a, B, device, stream);
}

}  // namespace sinddm

extern "C" {

// The block's two 3x3 stages; h1 (its depthwise stage) comes from dw_conv.cu.
#define SINDDM_STAGE1_ARGS                                                                   \
  const void *h1, const void *w1, const void *b1, void *g, int B, int H, int W, int C, int Co, \
      int device, void *stream
#define SINDDM_STAGE2_ARGS                                                                   \
  const void *g, const void *w2, const void *b2, const void *x, const void *wres,            \
      const void *bres, void *out, int B, int H, int W, int C, int Co, int device, void *stream

int sinddm_conv_stage1_f32(SINDDM_STAGE1_ARGS) {
  return sinddm::conv_stage1<float>(h1, w1, b1, g, B, H, W, C, Co, device, stream);
}

int sinddm_conv_stage1_bf16(SINDDM_STAGE1_ARGS) {
  return sinddm::conv_stage1<__nv_bfloat16>(h1, w1, b1, g, B, H, W, C, Co, device, stream);
}

int sinddm_conv_stage2_f32(SINDDM_STAGE2_ARGS) {
  return sinddm::conv_stage2<float>(g, w2, b2, x, wres, bres, out, B, H, W, C, Co, device, stream);
}

int sinddm_conv_stage2_bf16(SINDDM_STAGE2_ARGS) {
  return sinddm::conv_stage2<__nv_bfloat16>(g, w2, b2, x, wres, bres, out, B, H, W, C, Co, device,
                                            stream);
}

// The fp32 stages on wgmma: w1 / w2 / wres are split_weights' layout
// (ops/conv_block.py), C % 8 == 0 for stage 1 and Co % 8 == 0.
int sinddm_conv_stage1_f32_wgmma(SINDDM_STAGE1_ARGS) {
  return sinddm::conv_stage1_sm90(h1, w1, b1, g, B, H, W, C, Co, device, stream);
}

int sinddm_conv_stage2_f32_wgmma(SINDDM_STAGE2_ARGS) {
  return sinddm::conv_stage2_sm90(g, w2, b2, x, wres, bres, out, B, H, W, C, Co, device, stream);
}

const char* sinddm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
