// Fused patch extraction -> RBF cross-covariance of the last layer's
// patch-sum kernels, straight from the images:
//
//   patches[n]  = im2col(x_n)                 (TF order: p row-major over
//                                              (oy, ox), l over (fy, fx, c))
//   K[n,p,m]    = var * exp(gamma * max(pn_p + zn_m - 2 patches_p . z_m, 0))
//   Kzx[n,m]    = sum_p u_p K[n,p,m]
//   Kdiag[n]    = sum_pq w_p w_q Kd[n,p,q] / P^2        (ConvKernel only)
//   Kd[n,p,q]   = var * exp(gamma * max(pn_p + pn_q - 2 patches_p . patches_q, 0))
//
// with gamma = -0.5 / lengthscale^2 and pn, zn the squared row norms.
// Replaces the TPU kernel `_fwd_kernel` in deepcgp_tpu/ops/pallas_cross.py
// (:165).  The patch weights come in the stored TF patch order: the
// transposed patch order and the selection matrices of the TPU kernel
// worked around its compiler and carry no meaning here.
//
// What bounds it on an H100: the products.  At the flagship serving batch
// (N = 640 images of 10x10x10, f = 5, P = 36 patches of L = 250, M = 384)
// the cross products are 2 N P M L = 4.42 GFLOP and the symmetric Kdiag
// grams N P (P+1) L = 0.21 GFLOP, against ~4 MB of images, Z and outputs:
// 0.069 ms at the 67 TFLOP/s of float32 FMA, 0.028 ms as split-TF32
// tensor-core products (3 x 4.63 GFLOP at 495 TFLOP/s; 0.044 ms at the
// 318 TFLOP/s that mma.sync reaches).
//
// Precision: split TF32 (3xTF32).  Each float32 operand x is split into
// hi = x rounded to TF32 and lo = x - hi (exact; the tensor cores read it
// truncated to TF32), and a product takes lo*hi + hi*lo + hi*hi with
// float32 accumulation: each term is exact and the dropped lo*lo is below
// 2^-21 of |a||b|, so the distance pn + zn - 2 p.z keeps float32's
// accuracy where one TF32 pass (2^-11) would not (gamma amplifies the
// distance's error).  cuda_cross.conv_rbf_cross_3xtf32 emulates it.
//
// Design: a GEMM over flattened (image, patch) rows, mma.sync.m16n8k8.
// A block takes whole images, as many as fill 128 rows (P = 36: 3 images,
// 108 rows; P > 128: one image in row tiles of 128), so the u-weighted sum
// over p closes inside the block: no atomics, the same sums every run.
// Its blockIdx.y picks a 128-column tile of M or, with Kdiag, the gram of
// its rows with themselves; past one row tile, one pair a <= b of the
// image's row tiles a block (15 at P = 576), so that the gram, which one
// block walked tile pair by tile pair before (25 pairs against a Kzx
// block's 5 tiles: 0.55 of 0.063 ms at N = 32), leaves no tail.  Those
// blocks write their parts of Kdiag, an off-diagonal pair's twice, for
// the wrapper to sum.  8 warps, 4 x 2, each a 32 x 64 tile: 2 x 8
// m16n8 tiles, 64 float32 accumulators a lane; m16n8 tiles that hold no
// pair that counts (padding rows, columns past M, and in the gram pairs
// of two images) are skipped.
//  - Operands stream through a three-stage cp.async ring of k-chunks of
//    16 patch elements, one barrier a chunk; chunk c + 2 is issued before
//    chunk c is computed.  The patch rows are gathered from the images by
//    4-byte cp.async, a half-warp over 16 consecutive elements of a row
//    (im2col fused, zero-filled past the rows and L); Z comes from the
//    padded Zp [Mpad, Lpad] by 16-byte cp.async, once per block: no warp
//    reads Z from L1/L2.
//  - Z (or, past one row tile, the gram's column rows) is split into
//    (hi, lo) once, by the thread that staged it, into a double-buffered
//    float2 tile shared by the four row warps; the patch rows are split in
//    registers at the fragment load (each is read by two warps), and the
//    gram of one row tile reads its columns from the same rows.  The split
//    is two integer operations on the full-rate pipe, where
//    cvt.rna.tf32.f32 is a conversion at a fraction of that rate.
//  - A k-step issues the three passes over four n-tiles' eight m16n8
//    tiles one after another, so that no mma waits on the one before it.
//  - The row norms come from the fragments, a shuffle over the four lanes
//    of a row; Z's from the staging, a shuffle over the four stagers of a
//    row.
//  - Epilogue: clamp, exp and u_p-weighting on the accumulator fragments,
//    the values to a [128 x 132] shared tile, and one thread per (image,
//    column) sums its image's rows.  The [P, M] kernel matrix never
//    reaches device memory.  The gram's weighted exp is summed per row
//    over a warp's columns, then per image.
// What the first design (float32 FMA, one 5-warp block per image) lost,
// and what this one does about it: Z was never staged and each warp read
// the block's 384 KB of Z from L1/L2 (now one cp.async ring, split once);
// 32 FMA per 3 loads on the FMA pipe (now 48 mma per 24 shared loads on
// the tensor cores); row norms by 36 threads while 124 waited (now from
// the fragments, in parallel).
// What bounds this one, from the clock64() phases chip_smoke.py prints at
// N = 640 (H100, two blocks an SM): ~95k cycles a block, 81-84k of them
// the k-loop (16 chunks of 96 mma a warp: about half the rate of the
// 308-318 TFLOP/s that mma.sync TF32 reaches on the card, itself ~64% of
// the 495 of wgmma), 8-9k the epilogue, 3-5k the setup; 856 blocks on
// 264 slots are 3.24 waves.
// ptxas (sm_90a): 128 registers, 16 bytes spilled; 99,840 bytes of dynamic
// shared memory, the same at every geometry: two blocks an SM, and the
// kernel takes every geometry of the route's envelope
// (cuda_cross.envelope_bytes), any N, stride and dilation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;        // (image, patch) rows of a block tile
constexpr int kCols = 128;        // inducing (or gram) columns of a tile
constexpr int kKC = 16;           // patch elements a k-chunk
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kThreads = 256;
constexpr int kLdA = kKC + 4;     // raw patch rows: conflict-free fragments
constexpr int kLdB = kKC + 4;     // split columns (float2): the same
constexpr int kLdE = kCols + 4;   // epilogue tile
constexpr int kArawFloats = kStages * kRows * kLdA;
constexpr int kBrawFloats = kStages * kCols * kKC;
constexpr int kBsFloats = 2 * kCols * kLdB * 2;
constexpr int kPipeFloats = kArawFloats + kBrawFloats + kBsFloats;
static_assert(kPipeFloats >= kRows * kLdE, "the epilogue tile aliases the ring");
constexpr int kSmemFloats = kPipeFloats + kCols + 2 * kRows + 4 * kRows;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

struct Geo {
  int H, W, C, f, stride, dilation, Hout, Wout, P, L, HWC;
};

// (hi, lo) of a float32 x for the split-TF32 products.  hi is x rounded
// to TF32, to nearest with ties away from zero as cvt.rna.tf32.f32 rounds
// a finite x, by two integer operations on the full-rate pipe (the
// conversion instruction runs at a fraction of that rate).  lo = x - hi
// is exact in float32; the tensor cores read it truncated to TF32.  A NaN
// survives in lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows of row tile t that hold patches: the block's images' P rows each
// (one tile), or the tile's share of one image's P rows.
__device__ __forceinline__ int tile_rows(const Geo& g, int nrt, int gimg,
                                         int t) {
  return nrt == 1 ? gimg * g.P : min(kRows, g.P - t * kRows);
}

// Local row r of row tile t: its image among the block's (j), its patch
// (p), and the offset of its first element from the block's first image,
// or -1 (j = -1) past the tile's rows.
__device__ __forceinline__ int row_info(const Geo& g, int nrt, int gimg, int t,
                                        int r, int& j, int& p) {
  j = -1;
  p = 0;
  if (r >= tile_rows(g, nrt, gimg, t)) return -1;
  j = 0;
  p = t * kRows + r;
  if (nrt == 1) {
    j = r / g.P;
    p = r - j * g.P;
  }
  const int oy = p / g.Wout, ox = p - oy * g.Wout;
  return j * g.HWC + (oy * g.stride * g.W + ox * g.stride) * g.C;
}

// Bit 8 i + j: the warp's m-tile i (rows r0 + 16 i) and n-tile j (columns
// c0 + 8 j) hold a pair that counts -- rows and columns within their
// tiles and, for the gram, of one image.  Warp-uniform.
__device__ __forceinline__ uint32_t pair_mask(int P, int nrt, bool gram,
                                              int rows, int cols, int r0,
                                              int c0) {
  uint32_t mask = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 8; ++j) {
      const int ra = r0 + 16 * i, ca = c0 + 8 * j;
      if (ra >= rows || ca >= cols) continue;
      if (gram && nrt == 1) {
        const int rb = min(ra + 15, rows - 1), cb = min(ca + 7, cols - 1);
        if (rb / P < ca / P || cb / P < ra / P) continue;
      }
      mask |= 1u << (8 * i + j);
    }
  return mask;
}

// One k-step (8 patch elements) of a warp's 32 x 64 tile, given its A
// fragments split: four n-tiles at a time, the three passes over their
// eight tiles one after another, so that no mma waits on the one before
// it.  B comes from the split float2 tile or, for the gram of a single row
// tile (SELF: the columns are the rows), from the raw patch rows, split
// here.  MASKED skips the tiles whose bit in `need` is clear.
template <bool MASKED, bool SELF>
__device__ __forceinline__ void kstep(float (&acc)[2][8][4],
                                      const uint32_t (&ah)[2][4],
                                      const uint32_t (&al)[2][4],
                                      const float* A, const float2* B, int ks,
                                      int c0, int g8, int t4, uint32_t need) {
#pragma unroll
  for (int jh = 0; jh < 8; jh += 4) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = c0 + (jh + jj) * 8 + g8;
      if (SELF) {
        const float* b = A + col * kLdA + ks + t4;
        split_tf32(b[0], bh[jj][0], bl[jj][0]);
        split_tf32(b[4], bh[jj][1], bl[jj][1]);
      } else {
        const float2* b = B + col * kLdB + ks + t4;
        const float2 b0 = b[0], b1 = b[4];
        bh[jj][0] = __float_as_uint(b0.x);
        bl[jj][0] = __float_as_uint(b0.y);
        bh[jj][1] = __float_as_uint(b1.x);
        bl[jj][1] = __float_as_uint(b1.y);
      }
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (MASKED && !((need >> (8 * i + jh + jj)) & 1u)) continue;
          mma_tf32(acc[i][jh + jj], pass == 0 ? al[i] : ah[i],
                   pass == 1 ? bl[jj][0] : bh[jj][0],
                   pass == 1 ? bl[jj][1] : bh[jj][1]);
        }
  }
}

// Adds the cycles since the last stamp to phase i of this blockIdx.y.
__device__ __forceinline__ void stamp(long long* trace, int i) {
  const long long t = clock64();
  trace[3 * blockIdx.y + i] += t - trace[24 + blockIdx.y];
  trace[24 + blockIdx.y] = t;
}

__global__ void __launch_bounds__(kThreads, 2) conv_rbf_cross_kernel(
    const float* __restrict__ img, const float* __restrict__ Zp,
    const float* __restrict__ scal, const float* __restrict__ u,
    const float* __restrict__ wkd, float* __restrict__ kzx,
    float* __restrict__ kd, float* __restrict__ kdpart, Geo geo, int N,
    int M, int Mpad, int Lpad, int group, int with_kdiag,
    long long* __restrict__ trace) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Araw = smem;                        // [kStages][kRows][kLdA]
  float* Braw = Araw + kArawFloats;          // [kStages][kCols][kKC]
  float2* Bs = reinterpret_cast<float2*>(Braw + kBrawFloats);  // [2][kCols][kLdB]
  float* E = smem;                           // [kRows][kLdE], after the ring
  float* bn = smem + kPipeFloats;            // [kCols]: column-row norms
  float* rs = bn + kCols;                    // [2][kRows]: gram row sums
  int* roff = reinterpret_cast<int*>(rs + 2 * kRows);  // [2][kRows]: the A
                                             //   and gram-B rows' offsets
  int* rimg = roff + 2 * kRows;              // [kRows]: a row's image, or -1
  int* rp = rimg + kRows;                    // [kRows]: a row's patch

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;   // fragment row, column
  const int wr = w >> 1, wc = w & 1;         // 32-row, 64-column warp tile
  const int sr = tid >> 2, sq = tid & 3;     // Z: rows sr, sr + 64
  const int hr = tid >> 4, hk = tid & 15;    // patches: rows hr + 16 i
  const int P = geo.P, L = geo.L;
  const int n0 = blockIdx.x * group;
  const int gimg = min(group, N - n0);
  const int nrt = P > kRows ? (P + kRows - 1) / kRows : 1;
  const int mtiles = Mpad / kCols;
  const bool gram = static_cast<int>(blockIdx.y) >= mtiles;
  const bool self = gram && nrt == 1;        // the gram's columns are its rows
  // Past one row tile, each gram block takes one pair a <= b of row tiles
  // (numbered row by row) and writes its part of Kdiag to kdpart.
  int ga = 0, gb = 0;
  if (gram && nrt > 1) {
    int t = static_cast<int>(blockIdx.y) - mtiles;
    while (t >= nrt - ga) {
      t -= nrt - ga;
      ++ga;
    }
    gb = ga + t;
  }
  const int m0 = blockIdx.y * kCols;
  const float var = scal[0], gamma = scal[1];
  const int nk = (L + kKC - 1) / kKC;
  const int fC = geo.f * geo.C;
  const float inv_p2 = 1.0f / (static_cast<float>(P) * static_cast<float>(P));
  // clock64() phases of thread 0 of the middle block of each blockIdx.y,
  // when the caller asks for a trace (zeroed): setup, k-loop, epilogue
  // into trace[3 y ...], the last stamp in trace[24 + y] (kept in memory,
  // not in registers, so that tracing costs the kernel none).
  const bool traced = trace != nullptr && tid == 0 &&
                      blockIdx.x == gridDim.x / 2 && blockIdx.y < 8;
  if (traced) trace[24 + blockIdx.y] = clock64();

  if (!with_kdiag && blockIdx.y == 0 && tid < gimg) kd[n0 + tid] = 0.0f;

  float run = 0.0f;     // Kzx, P > 128: thread tid's column over the tiles
  const float* x = img + static_cast<size_t>(n0) * geo.HWC;
  const bool pair = gram && nrt > 1;
  for (int rt = pair ? ga : 0; rt < (pair ? ga + 1 : nrt); ++rt) {
    const int rows = tile_rows(geo, nrt, gimg, rt);
    for (int r = tid; r < kRows; r += kThreads)
      roff[r] = row_info(geo, nrt, gimg, rt, r, rimg[r], rp[r]);
    if (gram) rs[tid] = 0.0f;  // 2 x kRows = kThreads entries
    for (int ct = pair ? gb : 0; ct < (pair ? gb + 1 : 1); ++ct) {
      const int cols = gram ? tile_rows(geo, nrt, gimg, ct) : min(kCols, M - m0);
      if (gram && !self) {
        for (int r = tid; r < kRows; r += kThreads) {
          int j, p;
          roff[kRows + r] = row_info(geo, nrt, gimg, ct, r, j, p);
          bn[r] = 0.0f;
        }
      }
      __syncthreads();             // the row tables; the last tile is done
      const uint32_t need =
          pair_mask(P, nrt, gram, rows, cols, wr * 32, wc * 64);

      // Issue k-chunk c into ring slot c % kStages, as one group.  A
      // half-warp gathers 16 consecutive elements of one patch row (runs
      // of f C contiguous floats in the image).
      auto stage = [&](int c) {
        const int slot = c % kStages;
        float* As = Araw + slot * kRows * kLdA;
        float* Br = Braw + slot * kCols * kKC;
        const int k = c * kKC + hk;
        const bool kv = k < L;
        int lo = 0;
        if (kv) {
          const int fy = k / fC, rem = k - fy * fC;
          const int fx = rem / geo.C;
          lo = (fy * geo.dilation * geo.W + fx * geo.dilation) * geo.C + rem -
               fx * geo.C;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = hr + 16 * i;
          const int ra = roff[r];
          const bool va = kv && ra >= 0;
          cp_async4(As + r * kLdA + hk, va ? x + ra + lo : x, va);
          if (gram && !self) {
            const int rb = roff[kRows + r];
            const bool vb = kv && rb >= 0;
            cp_async4(Br + r * kKC + hk, vb ? x + rb + lo : x, vb);
          }
        }
        if (!gram) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = sr + 64 * i;
            cp_async16(Br + r * kKC + 4 * sq,
                       Zp + static_cast<size_t>(m0 + r) * Lpad + c * kKC + 4 * sq);
          }
        }
        cp_async_commit();
      };

      // Split this thread's own staged columns of chunk c into Bs[c & 1],
      // and add up their squared norms (the gram's over a half-warp, into
      // bn; Z's in registers).  The gram of one row tile stages no columns.
      float bnacc[2] = {0.0f, 0.0f};
      auto convert = [&](int c) {
        const float* Br = Braw + (c % kStages) * kCols * kKC;
        float2* Bd = Bs + (c & 1) * kCols * kLdB;
        if (self) return;
        if (gram) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = hr + 16 * i;
            const float v = Br[r * kKC + hk];
            uint32_t h, l;
            split_tf32(v, h, l);
            Bd[r * kLdB + hk] = make_float2(__uint_as_float(h), __uint_as_float(l));
            float q = v * v;
            q += __shfl_xor_sync(0xffffffffu, q, 1);
            q += __shfl_xor_sync(0xffffffffu, q, 2);
            q += __shfl_xor_sync(0xffffffffu, q, 4);
            q += __shfl_xor_sync(0xffffffffu, q, 8);
            if (hk == 0) bn[r] += q;
          }
          return;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = sr + 64 * i;
          const float4 v = *reinterpret_cast<const float4*>(Br + r * kKC + 4 * sq);
          bnacc[i] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
          uint32_t h[4], l[4];
          split_tf32(v.x, h[0], l[0]);
          split_tf32(v.y, h[1], l[1]);
          split_tf32(v.z, h[2], l[2]);
          split_tf32(v.w, h[3], l[3]);
          float4* dst = reinterpret_cast<float4*>(Bd + r * kLdB + 4 * sq);
          dst[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(l[0]),
                               __uint_as_float(h[1]), __uint_as_float(l[1]));
          dst[1] = make_float4(__uint_as_float(h[2]), __uint_as_float(l[2]),
                               __uint_as_float(h[3]), __uint_as_float(l[3]));
        }
      };

      float acc[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      float pnacc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

      // The ring: chunk c + 2 is issued before chunk c is computed, and
      // chunk c + 1 is awaited and split after it, so two chunks of
      // products cover each copy's latency; one barrier a chunk.
      if (traced) stamp(trace, 0);
      stage(0);
      if (nk > 1) {
        stage(1);
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
      convert(0);
      __syncthreads();
      for (int c = 0; c < nk; ++c) {
        if (c + 2 < nk) {
          stage(c + 2);
        } else {
          cp_async_commit();
        }
        const float* A = Araw + (c % kStages) * kRows * kLdA;
        const float2* B = Bs + (c & 1) * kCols * kLdB;
#pragma unroll
        for (int ks = 0; ks < kKC; ks += 8) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* a = A + (wr * 32 + i * 16 + g8) * kLdA + ks + t4;
            const float x0 = a[0], x1 = a[8 * kLdA], x2 = a[4],
                        x3 = a[8 * kLdA + 4];
            pnacc[i][0] += x0 * x0 + x2 * x2;
            pnacc[i][1] += x1 * x1 + x3 * x3;
            split_tf32(x0, ah[i][0], al[i][0]);
            split_tf32(x1, ah[i][1], al[i][1]);
            split_tf32(x2, ah[i][2], al[i][2]);
            split_tf32(x3, ah[i][3], al[i][3]);
          }
          const int c0 = wc * 64;
          if (self) {
            if (need == 0xFFFFu)
              kstep<false, true>(acc, ah, al, A, B, ks, c0, g8, t4, need);
            else
              kstep<true, true>(acc, ah, al, A, B, ks, c0, g8, t4, need);
          } else if (need == 0xFFFFu) {
            kstep<false, false>(acc, ah, al, A, B, ks, c0, g8, t4, need);
          } else {
            kstep<true, false>(acc, ah, al, A, B, ks, c0, g8, t4, need);
          }
        }
        cp_async_wait<1>();        // this thread's copies of chunk c + 1
        if (c + 1 < nk) convert(c + 1);
        __syncthreads();
      }
      cp_async_wait<0>();
      if (traced) stamp(trace, 1);

      // Norms: a row's four stagers, a fragment row's four lanes; the gram
      // of one row tile takes its column norms from its rows'.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = bnacc[i];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (!gram && sq == 0) bn[sr + 64 * i] = v;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pnacc[i][h] += __shfl_xor_sync(0xffffffffu, pnacc[i][h], 1);
          pnacc[i][h] += __shfl_xor_sync(0xffffffffu, pnacc[i][h], 2);
          if (self && wc == 0 && t4 == 0)
            bn[wr * 32 + i * 16 + g8 + 8 * h] = pnacc[i][h];
        }
      }
      __syncthreads();             // bn written; every copy has landed

      if (!gram) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wr * 32 + i * 16 + g8 + 8 * h;
            const int p = nrt == 1 ? rp[r] : rt * kRows + r;
            const float up = r < rows ? __ldg(u + p) : 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = wc * 64 + j * 8 + 2 * t4;
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float d2 =
                    pnacc[i][h] + bn[col + e] - 2.0f * acc[i][j][2 * h + e];
                v[e] = up * (var * expf(gamma * fmaxf(d2, 0.0f)));
              }
              *reinterpret_cast<float2*>(E + r * kLdE + col) =
                  make_float2(v[0], v[1]);
            }
          }
        __syncthreads();
        if (nrt == 1) {
          for (int o = tid; o < gimg * kCols; o += kThreads) {
            const int j = o / kCols, c = o - j * kCols;
            float s = 0.0f;
            for (int p = 0; p < P; ++p) s += E[(j * P + p) * kLdE + c];
            if (m0 + c < M) kzx[static_cast<size_t>(n0 + j) * M + m0 + c] = s;
          }
        } else if (tid < kCols) {
          float s = 0.0f;
          for (int r = 0; r < rows; ++r) s += E[r * kLdE + tid];
          run += s;
          if (rt == nrt - 1 && m0 + tid < M)
            kzx[static_cast<size_t>(n0) * M + m0 + tid] = run;
        }
      } else {
        // The gram: w_p w_q Kd on the pairs of one image, summed per row
        // over this warp's columns, then over the row's four lanes.
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wr * 32 + i * 16 + g8 + 8 * h;
            const int jr = nrt == 1 ? rimg[r] : 0;
            float s = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = wc * 64 + j * 8 + 2 * t4 + e;
                const bool same = nrt == 1 ? rimg[c] == jr : true;
                if (r < rows && c < cols && same) {
                  const int pc = nrt == 1 ? rp[c] : ct * kRows + c;
                  const float e2 = pnacc[i][h] + bn[c] - 2.0f * acc[i][j][2 * h + e];
                  s += __ldg(wkd + pc) * (var * expf(gamma * fmaxf(e2, 0.0f)));
                }
              }
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (t4 == 0 && r < rows) {
              const int pr = nrt == 1 ? rp[r] : rt * kRows + r;
              rs[wc * kRows + r] += __ldg(wkd + pr) * s;
            }
          }
      }
      __syncthreads();             // E, bn, rs and the tables are rewritten next
      if (traced) stamp(trace, 2);
    }
    if (gram) {
      if (nrt == 1) {
        if (tid < gimg) {
          float s = 0.0f;
          for (int p = tid * P; p < (tid + 1) * P; ++p) s += rs[p] + rs[kRows + p];
          kd[n0 + tid] = s * inv_p2;
        }
      } else if (tid == 0) {
        float s = 0.0f;
        for (int r = 0; r < rows; ++r) s += rs[r] + rs[kRows + r];
        const int npairs = nrt * (nrt + 1) / 2;
        kdpart[static_cast<size_t>(n0) * npairs + blockIdx.y - mtiles] =
            (ga == gb ? 1.0f : 2.0f) * s * inv_p2;
      }
      __syncthreads();             // rs is cleared for the next row tile
    }
  }
}

}  // namespace

// Dynamic shared memory of one block (the same at every geometry).
extern "C" size_t conv_rbf_cross_smem_bytes() {
  return kSmemFloats * sizeof(float);
}

static int launch(const float* img, const float* Zp, const float* scal,
                  const float* u, const float* wkd, float* kzx, float* kd,
                  float* kdpart, int N, int H, int W, int C, int f, int stride,
                  int dilation, int M, int Mpad, int Lpad, int group,
                  int with_kdiag, long long* trace, void* stream) {
  Geo g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.f = f;
  g.stride = stride;
  g.dilation = dilation;
  const int eff = (f - 1) * dilation + 1;
  g.Hout = (H - eff) / stride + 1;
  g.Wout = (W - eff) / stride + 1;
  g.P = g.Hout * g.Wout;
  g.L = f * f * C;
  g.HWC = H * W * C;
  if (N < 1 || g.Hout < 1 || g.Wout < 1 || Mpad % kCols || Mpad < M ||
      Lpad % kKC || Lpad < g.L || group < 1 ||
      (g.P > kRows ? group != 1 : group * g.P > kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = conv_rbf_cross_smem_bytes();
  if (smem > kDefaultSmem) {
    // Opt in to more dynamic shared memory than a launch gets by default,
    // once per device.
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    static bool opted[kMaxDevices] = {};
    if (dev >= kMaxDevices || !opted[dev]) {
      err = cudaFuncSetAttribute(conv_rbf_cross_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) opted[dev] = true;
    }
  }
  const int nrt = (g.P + kRows - 1) / kRows;
  const int grams = !with_kdiag ? 0 : nrt > 1 ? nrt * (nrt + 1) / 2 : 1;
  if (with_kdiag && nrt > 1 && kdpart == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + group - 1) / group, Mpad / kCols + grams);
  conv_rbf_cross_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      img, Zp, scal, u, wkd, kzx, kd, kdpart, g, N, M, Mpad, Lpad, group,
      with_kdiag, trace);
  return static_cast<int>(cudaGetLastError());
}

// img [N, H, W, C]; Zp [Mpad, Lpad] = Z zero-padded (Mpad a multiple of
// 128, Lpad of 16, Lpad >= L); scal [2] = (variance, gamma); u [P] and wkd
// [P] in TF patch order: contiguous float32 on the device.  `group` whole
// images a block (group * P <= 128), or 1 where P > 128.  Writes kzx [N, M]
// and kd [N] (zeros unless with_kdiag) -- but where P > 128, with Kdiag,
// the parts of Kdiag of each pair a <= b of R = ceil(P / 128) row tiles
// into kdpart [N, R (R + 1) / 2] instead, for the caller to sum.  Launches
// on `stream`, allocates nothing, and returns the first CUDA error.
extern "C" int conv_rbf_cross(const float* img, const float* Zp,
                              const float* scal, const float* u,
                              const float* wkd, float* kzx, float* kd,
                              float* kdpart, int N, int H, int W, int C,
                              int f, int stride, int dilation, int M, int Mpad,
                              int Lpad, int group, int with_kdiag,
                              void* stream) {
  return launch(img, Zp, scal, u, wkd, kzx, kd, kdpart, N, H, W, C, f,
                stride, dilation, M, Mpad, Lpad, group, with_kdiag, nullptr,
                stream);
}

// The same launch, adding the clock64() cycles of the setup, the k-loop
// and the epilogue of thread 0 of the middle block of each blockIdx.y
// (< 8) into trace [32] (zeroed by the caller): [3 y + phase].
extern "C" int conv_rbf_cross_traced(
    const float* img, const float* Zp, const float* scal, const float* u,
    const float* wkd, float* kzx, float* kd, float* kdpart, int N, int H,
    int W, int C, int f, int stride, int dilation, int M, int Mpad, int Lpad,
    int group, int with_kdiag, long long* trace, void* stream) {
  return launch(img, Zp, scal, u, wkd, kzx, kd, kdpart, N, H, W, C, f,
                stride, dilation, M, Mpad, Lpad, group, with_kdiag, trace,
                stream);
}
