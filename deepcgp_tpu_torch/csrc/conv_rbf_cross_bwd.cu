// Backward of the fused patch extraction -> RBF cross-covariance
// (csrc/conv_rbf_cross.cu): given the cotangents dKzx [N, M] and
// dKdiag [N], the gradients with respect to the images, Z, the variance,
// gamma and the two patch-weight vectors.  With, per image n,
//
//   D[p,m]  = pn_p + zn_m - 2 patches_p . z_m,   K = var exp(gamma max(D, 0))
//   AUK     = u_p dKzx[n,m] K[p,m],              T = gamma AUK [D > 0]
//   E[p,q]  = pn_p + pn_q - 2 patches_p . patches_q,
//   Kd      = var exp(gamma max(E, 0)),
//   base    = dKdiag[n] w_p w_q Kd / P^2,        S = gamma base [E > 0]
//
// the gradients are
//
//   dpatches = -2 T Z + 2 patches rowsum(T) - 2 (S + S^T) patches
//              + 2 patches rowsum(S + S^T)       (col2im'd into d images)
//   dZ       = sum_n (-2 T^T patches + 2 Z colsum(T))
//   dvar     = (sum AUK + sum base) / var,  dgamma = sum (AUK max(D, 0))
//              + sum (base max(E, 0)),
//   du_p     = sum_{n,m} dKzx K,  dwkd_p = sum_n dKdiag 2 sum_q w_q Kd / P^2.
//
// Replaces the TPU kernel `_bwd_kernel` in deepcgp_tpu/ops/pallas_cross.py,
// without its selection matrices, transposed patch order and packed
// partial rows (compiler workarounds there).  The masks are strict
// (D > 0, E > 0), as in the TPU kernel.
//
// What bounds it on an H100: arithmetic, if the card is kept busy.  At
// the flagship training step (N = 320 images of 10x10x10, f = 5, P = 36,
// L = 250, M = 384) the recomputed cross products, T Z and T^T patches are
// 3 x 2 N P M L = 6.6 GFLOP, the gram and its product 0.3 GFLOP, against
// ~4 MB of inputs and outputs.  The image side's products are float32
// FMA; the Z side's T^T patches (2 N P M L = 2.2 GFLOP: 0.033 ms at the
// 67 TFLOP/s of float32 FMA, 0.0134 ms as split-TF32 tensor-core products,
// 3 x 2.2 GFLOP at 495 TFLOP/s; reading T, 17.7 MB, takes 0.0053 ms)
// run on the tensor cores in split TF32 (see csrc/conv_rbf_cross.cu).
// The first design (one block of P/8 warps per image) ran the image side
// at ~5 TFLOP/s: 320 blocks of 5 warps, two an SM by registers (175) and
// shared memory (109 KB), left a ragged second wave of 56 blocks and 10
// warps an SM to hide one L2 round trip per row of Z.
//
// Design: two launches.  dZ sums over every image, and one [M, L] partial
// per image would be 123 MB at the flagship, so the work splits:
//  1. image side, for P <= 64 (for P > 64 bwd_image_kernel_tiled, below,
//     whose d images take a third launch), one thread-block cluster per
//     image, one block per 128-column tile of M (S = Mpad / 128 blocks, at
//     most 8; a block takes the tiles rank, rank + S, ...), two warps per
//     8-row group, one a 64-column half of each tile.  A block holds the
//     image's patch matrix (transposed) in shared memory, streams its tile
//     of Z through a two-stage cp.async ring (8 KB a stage: 16 rows of
//     Z^T for the cross products, then whole rows of Z for T Z),
//     recomputes its tile of the cross-covariance (8 rows x 2 columns a
//     lane), writes T [N, P, Mpad]
//     to device memory (17.7 MB at the flagship) and accumulates its part
//     of T Z in registers.  The image's gram is dealt out too: each block
//     takes the pairs p <= q whose index in the upper triangle is its rank
//     mod S (S is symmetric, so a pair gives both entries of E; then a
//     warp takes a row, a lane a column, and sums the row's w_q Kd[p, q]
//     in a fixed order, not by atomics) and adds
//     2 S_own patches to its part, so the parts sum to T Z + 2 S patches
//     and no block needs another's S.  At the flagship: 960 blocks of 10
//     warps, ~103 KB of shared memory and at most 102 registers, so two
//     blocks and 20 warps an SM; wider blocks (P > 40 or L > 256, up to 16
//     warps) take one.  The parts meet over distributed shared memory:
//     the patch-element columns are dealt out by rank (column l to the
//     rank of its channel, l mod C mod S); each block sums its columns
//     over the cluster in rank order, adds the row-sum term and col2im's
//     its channels' pixels through tables of the patches that cover each
//     image row and column -- a gather, no atomics, the same order every
//     run.  Per-(image, rank) partials of du, dwkd, dvar and dgamma go to
//     device memory for the wrapper to sum.  conv_rbf_cross_bwd_image_traced
//     stamps the phases of one block with clock64();
//  2. Z side, dZ = 2 (Z colsum T - T^T patches): a deep-K GEMM
//     [M, N P] x [N P, L] (K = 11,520 at the flagship) in split-TF32
//     mma.sync.m16n8k8 (the scheme of csrc/conv_rbf_cross.cu).  A block
//     computes a 128 x 64 tile of dZ (L in 64-column tiles: 6 padded
//     columns at L = 250, 20 at 300) over its share of the N P rows; a
//     thread-block cluster of up to 16 blocks splits those rows
//     (cuda_cross.z_side_cluster: 12 tiles x 16 = 192 blocks at the
//     flagship).  8 warps, 4 x 2, each 32 x 32 (2 x 4 m16n8 tiles).  Rows
//     of T (contiguous in Mpad) stream by 16-byte cp.async through a
//     four-stage ring, chunk c + 3 issued before chunk c is computed; the
//     patch elements of chunk c + 2 are loaded into registers after chunk
//     c's products, a half-warp over 16 consecutive elements of a row (a
//     first version gathered them by 4-byte cp.async into the ring).  The thread that staged or loaded an element splits it
//     into (hi, lo) once, into double-buffered float2 tiles, and sums its
//     T into colsum T on the way; one barrier a chunk.  The blocks of a
//     cluster sum their parts over distributed shared memory in rank
//     order, each rank its own rows of the tile, and write dZ: no atomics
//     and no memset, the same bits every run.
//     The first Z side (float32 FMA, 528 blocks of 64 rows x 128 columns x
//     8 images) took two barriers and an unbuffered gather of T and the
//     patches per image for 36 inner steps, and padded L = 250 to 256 in
//     128-column tiles: latency-bound at 17.7 TFLOP/s.  What bounds this
//     one: the tiles re-read their operands from L2 (T by 4 column tiles,
//     the patches by 3 row tiles: ~106 MB at the flagship, against 17.7 MB
//     of T), and the split and staging of them, as much as the products.
//     ptxas (sm_90a): 102 registers, no spills; 88,832 bytes of dynamic
//     shared memory: two blocks an SM.
// The image side's products stay float32 FMA.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;       // patch rows per warp
constexpr int kMT = 128;       // inducing columns / patch elements per tile
constexpr int kHalfT = 64;     // columns of a tile one warp covers, 2 a lane
constexpr int kMaxWarps = 16;  // 8 row groups (P <= 64) x 2 halves
constexpr int kMaxCluster = 8; // blocks an image: a portable cluster
constexpr int kStage = 2048;   // floats of Z a stage holds (8 KB)
constexpr int kLC = kStage / kMT;  // rows of Z^T a cross-product stage holds
// The Z side: a block is a 128 x 64 tile of dZ over a k-range of the
// flattened (image, patch) rows, 8 warps; a cluster splits the rows.
constexpr int kZTM = 128;      // rows of Z a tile
constexpr int kZTL = 64;       // patch elements a tile
constexpr int kZKC = 16;       // (image, patch) rows a k-chunk
constexpr int kZStages = 4;    // cp.async ring depth
constexpr int kZThreads = 256;
constexpr int kZLdT = kZTM + 4;  // split tiles (float2): conflict-free fragments
constexpr int kZLdX = kZTL + 4;
constexpr int kZLdR = kZTL + 4;
constexpr int kZMaxCluster = 16;  // above 8: a non-portable cluster size
constexpr int kZPipeFloats =
    kZStages * kZKC * kZTM + 2 * kZKC * kZLdT * 2 + 2 * kZKC * kZLdX * 2;
static_assert(kZPipeFloats >= kZTM * kZLdR, "the reduction tile aliases the ring");
constexpr int kZSmemFloats = kZPipeFloats + kZTM + 8 * kZTM + kZTL;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__host__ __device__ inline int padded_rows(int P) { return (P + 7) / 8 * 8; }

// The image side's block takes two warps per 8-row group, one a 64-column
// half of each tile.  Up to 10 warps with dpatches accumulators over at
// most 2 tiles of L it is built for two blocks an SM (at most 102
// registers); wider ones, up to 16 warps, for one.
__host__ __device__ inline bool image_wide(int P, int L) {
  return padded_rows(P) / kRows > 5 || L > 2 * kMT;
}

// Image-side cluster size: one block per 128-column tile of Mpad, at most
// a portable cluster's 8 (a block then takes several tiles).
__host__ __device__ inline int image_cluster(int Mpad) {
  return Mpad / kMT < kMaxCluster ? Mpad / kMT : kMaxCluster;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 16 bytes, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16z(float* smem, const float* gmem,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// (hi, lo) of a float32 x for the split-TF32 products: hi is x rounded to
// TF32, to nearest with ties away from zero as cvt.rna.tf32.f32 rounds a
// finite x, by two integer operations on the full-rate pipe (the
// conversion instruction runs at a fraction of its rate); lo = x - hi is
// exact, and the tensor cores read it truncated to TF32.  A NaN survives
// in lo.
__device__ __forceinline__ float2 split_tf32(float x) {
  const float hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
  return make_float2(hi, x - hi);
}

// The (hi, lo) of four values, stored as four float2.
__device__ __forceinline__ void split_store4(float2* dst, float4 v) {
  const float2 a = split_tf32(v.x), b = split_tf32(v.y), c = split_tf32(v.z),
               d = split_tf32(v.w);
  float4* o = reinterpret_cast<float4*>(dst);
  o[0] = make_float4(a.x, a.y, b.x, b.y);
  o[1] = make_float4(c.x, c.y, d.x, d.y);
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

// Stage rows row0 .. row0 + rows - 1 of the first `width` columns of a
// row-major matrix (leading dimension ld, both multiples of 4) into dst
// [rows][width] by cp.async, as one committed group of the whole block.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int ld, int width, int row0,
                                           int rows) {
  const int q = width / 4;
  for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
    const int r = i / q, c = 4 * (i % q);
    cp_async16(dst + r * width + c,
               src + static_cast<size_t>(row0 + r) * ld + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline int patch_offset(int l, int f, int C, int W, int dilation) {
  const int fy = l / (f * C), r = l % (f * C);
  const int fx = r / C, c = r % C;
  return ((fy * dilation) * W + fx * dilation) * C + c;
}


// clock64() at the image side's phase boundaries, thread 0 of the middle
// block only, when the caller asks for a trace (else a null pointer).
#define K5_STAMP(i)                                                        \
  if (trace != nullptr && tid == 0 && blockIdx.x == gridDim.x / 2)         \
    trace[i] = clock64();

template <int NLT, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 512 : 320, WIDE ? 1 : 2)
    bwd_image_kernel(const float* __restrict__ img,
                     const float* __restrict__ Zt,
                     const float* __restrict__ Zp,
                     const float* __restrict__ zn,
                     const float* __restrict__ scal,
                     const float* __restrict__ u,
                     const float* __restrict__ wkd,
                     const float* __restrict__ dkzx,
                     const float* __restrict__ dkd, float* __restrict__ Tg,
                     float* __restrict__ part, float* __restrict__ dimg,
                     int H, int W, int C, int f, int stride, int dilation,
                     int Hout, int Wout, int M, int Mpad, int with_kdiag,
                     long long* __restrict__ trace) {
  constexpr int Lpad = NLT * kMT;
  constexpr int MC = kStage / Lpad;   // rows of Z a T Z stage holds
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = Hout * Wout;
  const int L = f * f * C;
  const int Ppad = padded_rows(P);
  const int G = Ppad / kRows;
  const int Sp = Ppad + 1;
  const int Usize = kMT * Ppad > Ppad * Lpad ? kMT * Ppad : Ppad * Lpad;
  float* PsT = smem;                  // [L][Ppad]: patches, transposed
  float* TT = PsT + L * Ppad;         // [kMT][Ppad]: T of one column tile;
  float* Xs = TT;                     //   then [Ppad][Lpad]: dpatches
  float* Zs = TT + Usize;             // [2][kStage]: staged rows of Z
  float* SS = Zs + 2 * kStage;        // [Ppad][Sp]: S on this rank's pairs
  float* pn = SS + Ppad * Sp;         // [Ppad]
  float* dws = pn + Ppad;             // [Ppad]: sum_q w_q Kd[p, q], own pairs
  float* rowTp = dws + Ppad;          // [Ppad]: this block's row sums of
                                      //   T and of S + S^T on its pairs
  float* rowTt = rowTp + Ppad;        // [Ppad]: the image's
  float* hsum = rowTt + Ppad;         // [2 halves][du, rowT][Ppad]
  float* red = hsum + 4 * Ppad;       // [2 kMaxWarps]

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int g = w % G, h = w / G;     // row group, half
  const int n = blockIdx.x / S;
  const float var = scal[0];
  const float gamma = scal[1];
  const int HWC = H * W * C;
  const float* x = img + static_cast<size_t>(n) * HWC;
  K5_STAMP(0);

  // The image into shared memory (TT's space, unused until T), where it
  // fits, and each patch element's offset in it (the Z stages' space);
  // then im2col, transposed: a warp a patch element l, a lane a patch row
  // (P <= 64, so two at most); padded rows are zeros.
  const int nwarps = blockDim.x / 32;
  int* loff = reinterpret_cast<int*>(Zs);
  for (int l = tid; l < L; l += blockDim.x)
    loff[l] = patch_offset(l, f, C, W, dilation);
  if (HWC <= Usize) {
    for (int t = tid; t < HWC; t += blockDim.x) TT[t] = __ldg(x + t);
    x = TT;
  }
  __syncthreads();
  int poff[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int p = lane + 32 * k;
    poff[k] = p < P ? ((p / Wout) * stride * W + (p % Wout) * stride) * C : -1;
  }
  for (int l = w; l < L; l += nwarps) {
    const int lo = loff[l];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = lane + 32 * k;
      if (p < Ppad) PsT[l * Ppad + p] = poff[k] >= 0 ? x[poff[k] + lo] : 0.0f;
    }
  }
  for (int p = tid; p < Ppad; p += blockDim.x) dws[p] = 0.0f;
  for (int i = tid; i < 4 * Ppad; i += blockDim.x) hsum[i] = 0.0f;
  for (int i = tid; i < Ppad * Sp; i += blockDim.x) SS[i] = 0.0f;
  __syncthreads();
  for (int p = w; p < Ppad; p += nwarps) {   // squared norms, a warp a row
    float s = 0.0f;
    for (int l = lane; l < L; l += 32) {
      const float v = PsT[l * Ppad + p];
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) pn[p] = s;
  }
  __syncthreads();

  K5_STAMP(1);
  float dvar_acc = 0.0f, dgam_acc = 0.0f;
  const float inv_p2 = 1.0f / (static_cast<float>(P) * static_cast<float>(P));
  const float dd = with_kdiag ? dkd[n] : 0.0f;
  if (with_kdiag) {
    // This rank's share of the image's gram: the pairs p <= q whose
    // index t in the upper triangle, row by row, has t mod S == rank.
    // E is symmetric (E[p,q] and E[q,p] are the same sums term for term),
    // so each pair's thread writes both entries of E into SS.
    for (int t = tid * S + rank; t < P * (P + 1) / 2; t += blockDim.x * S) {
      int p = 0, q = t;
      while (q >= P - p) {
        q -= P - p;
        ++p;
      }
      q += p;
      float gr = 0.0f;
      for (int l = 0; l < L; ++l) gr += PsT[l * Ppad + p] * PsT[l * Ppad + q];
      const float e = pn[p] + pn[q] - 2.0f * gr;
      SS[p * Sp + q] = e;
      SS[q * Sp + p] = e;
    }
    __syncthreads();
    // Then a warp takes a row p, a lane the columns q of the row's own
    // entries: Kd, the gram terms of dvar and dgamma, S in place of E, and
    // the row sum dws[p] = sum_q w_q Kd[p, q] as the lanes' sums in column
    // order and a butterfly -- an order fixed by the geometry, so the
    // patch-weight gradient has the same bits run to run, as atomics,
    // which add in the order the threads arrive, would not.
    for (int p = w; p < P; p += nwarps) {
      float ws = 0.0f;
      for (int q = lane; q < P; q += 32) {
        const int a = min(p, q), b = max(p, q);
        if ((a * P - a * (a - 1) / 2 + b - a) % S != rank) continue;
        const float e = SS[p * Sp + q];
        const float eh = fmaxf(e, 0.0f);
        const float kd = var * expf(gamma * eh);
        // w_p w_q first, so that both entries of a pair get the same bits.
        const float base = dd * (wkd[p] * wkd[q]) * inv_p2 * kd;
        dvar_acc += base;
        dgam_acc += base * eh;
        SS[p * Sp + q] = e > 0.0f ? base * gamma : 0.0f;
        ws += wkd[q] * kd;
      }
      ws = warp_sum(ws);
      if (lane == 0) dws[p] = ws;
    }
  }

  K5_STAMP(2);
  const int pw = g * kRows;          // this warp's first patch row
  const int cw = h * kHalfT + 2 * lane;  // the lane's first column of a tile
  float dx[kRows][2 * NLT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 2 * NLT; ++c) dx[r][c] = 0.0f;

  const int ntiles = Mpad / kMT;
  for (int tile = rank; tile < ntiles; tile += S) {
    const int m0 = tile * kMT;
    // Cross products of the warp's 8 rows with the lane's 2 columns, over
    // rows of the Z^T tile staged kLC at a time (cp.async, two stages).
    float acc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
    const int nlc = (L + kLC - 1) / kLC;
    stage_rows(Zs, Zt + m0, Mpad, kMT, 0, min(kLC, L));
    for (int ch = 0; ch < nlc; ++ch) {
      if (ch + 1 < nlc) {
        stage_rows(Zs + ((ch + 1) & 1) * kStage, Zt + m0, Mpad, kMT,
                   (ch + 1) * kLC, min(kLC, L - (ch + 1) * kLC));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* zs = Zs + (ch & 1) * kStage + cw;
      const int l0 = ch * kLC, rows = min(kLC, L - l0);
#pragma unroll 4
      for (int i = 0; i < rows; ++i) {
        const float* row = PsT + (l0 + i) * Ppad + pw;
        const float4 a0 = *reinterpret_cast<const float4*>(row);
        const float4 a1 = *reinterpret_cast<const float4*>(row + 4);
        const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float2 z = *reinterpret_cast<const float2*>(zs + i * kMT);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] += a[r] * z.x;
          acc[r][1] += a[r] * z.y;
        }
      }
      __syncthreads();  // this stage is refilled two chunks on
    }
    K5_STAMP(3);
    // The rows of T Z's first stage load while T is formed.
    const int mlim = min(kMT, M - m0);
    const int nmc = (mlim + MC - 1) / MC;
    stage_rows(Zs, Zp + static_cast<size_t>(m0) * Lpad, Lpad, Lpad, 0,
               min(MC, mlim));

    {
      float a[2], znj[2], du_r[kRows], rowT[kRows];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + cw + j;
        a[j] = m < M ? dkzx[static_cast<size_t>(n) * M + m] : 0.0f;
        znj[j] = __ldg(zn + m);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int p = pw + r;
        const float up = p < P ? __ldg(u + p) : 0.0f;
        float tv[2];
        du_r[r] = rowT[r] = 0.0f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float d2 = pn[p] + znj[j] - 2.0f * acc[r][j];
          const float dh = fmaxf(d2, 0.0f);
          const float ak = a[j] * (var * expf(gamma * dh));
          const float auk = up * ak;
          dvar_acc += auk;
          dgam_acc += auk * dh;
          const float t = d2 > 0.0f ? auk * gamma : 0.0f;
          du_r[r] += ak;
          rowT[r] += t;
          tv[j] = t;
          TT[(cw + j) * Ppad + p] = t;
        }
        if (p < P) {
          *reinterpret_cast<float2*>(
              Tg + (static_cast<size_t>(n) * P + p) * Mpad + m0 + cw) =
              make_float2(tv[0], tv[1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float du = warp_sum(du_r[r]);
        const float rt = warp_sum(rowT[r]);
        if (lane == 0) {
          hsum[(2 * h) * Ppad + pw + r] += du;
          hsum[(2 * h + 1) * Ppad + pw + r] += rt;
        }
      }
    }

    K5_STAMP(4);
    // This block's part of dpatches: += T Z over the tile's rows of Z,
    // staged MC at a time.
    for (int ch = 0; ch < nmc; ++ch) {
      if (ch + 1 < nmc) {
        stage_rows(Zs + ((ch + 1) & 1) * kStage,
                   Zp + static_cast<size_t>(m0) * Lpad, Lpad, Lpad,
                   (ch + 1) * MC, min(MC, mlim - (ch + 1) * MC));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // also: TT is complete
      const float* zs = Zs + (ch & 1) * kStage + cw;
      const int r0 = ch * MC, rows = min(MC, mlim - r0);
      for (int i = 0; i < rows; ++i) {
        const float4 t0 = *reinterpret_cast<const float4*>(TT + (r0 + i) * Ppad + pw);
        const float4 t1 =
            *reinterpret_cast<const float4*>(TT + (r0 + i) * Ppad + pw + 4);
        const float tr[kRows] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
        for (int lt = 0; lt < NLT; ++lt) {
          const float2 z =
              *reinterpret_cast<const float2*>(zs + i * Lpad + lt * kMT);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            dx[r][2 * lt] += tr[r] * z.x;
            dx[r][2 * lt + 1] += tr[r] * z.y;
          }
        }
      }
      __syncthreads();  // this stage is refilled; TT by the next tile
    }
  }

  K5_STAMP(5);
  if (with_kdiag) {
    // The block's part of the gram term: S on its own pairs (both entries,
    // zeros elsewhere), so that the parts sum to S over the cluster.  S is
    // symmetric, so -2 (S + S^T) patches = -4 S patches, and the block
    // adds 2 S_own patches to its part of T Z, which the reduction scales
    // by -2.  The patches go to Xs in [Ppad][Lpad] for the product (TT
    // is no longer read; columns from L on are not written and not used).
    for (int p = w; p < Ppad; p += nwarps)
      for (int l = lane; l < L; l += 32) Xs[p * Lpad + l] = PsT[l * Ppad + p];
    __syncthreads();
    for (int q = 0; q < P; ++q) {
      float sq[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sq[r] = 2.0f * SS[(pw + r) * Sp + q];
#pragma unroll
      for (int lt = 0; lt < NLT; ++lt) {
        const float2 xq =
            *reinterpret_cast<const float2*>(Xs + q * Lpad + lt * kMT + cw);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dx[r][2 * lt] += sq[r] * xq.x;
          dx[r][2 * lt + 1] += sq[r] * xq.y;
        }
      }
    }
    __syncthreads();  // every read of the patches in Xs is done
  }
  // The block's part of T Z (+ 2 S patches) into Xs.
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int lt = 0; lt < NLT; ++lt)
      *reinterpret_cast<float2*>(Xs + (pw + r) * Lpad + lt * kMT + cw) =
          make_float2(dx[r][2 * lt], dx[r][2 * lt + 1]);
  __syncthreads();
  const size_t pbase = (static_cast<size_t>(n) * S + rank) * (2 * P + 2);
  for (int p = tid; p < Ppad; p += blockDim.x) {
    const float du = hsum[p] + hsum[2 * Ppad + p];
    float rs = 0.0f;  // this block's part of the row sums of S + S^T
    for (int q = 0; q < P; ++q) rs += SS[p * Sp + q];
    rowTp[p] = hsum[Ppad + p] + hsum[3 * Ppad + p] + 2.0f * rs;
    if (p < P) part[pbase + p] = du;
  }
  cluster.sync();  // every rank's Xs and rowTp are written
  K5_STAMP(6);

  for (int p = tid; p < Ppad; p += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < S; ++r) s += cluster.map_shared_rank(rowTp, r)[p];
    rowTt[p] = s;
  }
  __syncthreads();

  // dpatches on this rank's columns: the channels c with c mod S == rank,
  // kU elements a thread at once, so that their loads overlap.
  const int nch = (C - rank + S - 1) / S;
  const int own = f * f * nch;
  const int total = P * own;
  constexpr int kU = 4;
  for (int t0 = tid; t0 < total; t0 += kU * blockDim.x) {
    int idx[kU];
    float d[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = min(t0 + u * static_cast<int>(blockDim.x), total - 1);
      const int p = t / own, i = t - p * own;
      const int pos = i / nch;
      const int l = pos * C + rank + S * (i - pos * nch);
      idx[u] = p * Lpad + l;
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < S) v += cluster.map_shared_rank(Xs, r)[idx[u]];
      d[u] = -2.0f * v + 2.0f * rowTt[p] * PsT[l * Ppad + p];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (t0 + u * static_cast<int>(blockDim.x) < total) Xs[idx[u]] = d[u];
  }
  K5_STAMP(7);
  cluster.sync();  // no rank reads another's shared memory after this
  K5_STAMP(8);

  // col2im of this rank's channels: each pixel gathers the patch elements
  // that read it, through tables (in the Z stages' space, where they fit)
  // of the patch rows and filter rows that cover each image row, and the
  // same for columns.
  const bool tables = (H + W) * (f + 1) <= 2 * kStage;
  int* ytab = reinterpret_cast<int*>(Zs);  // [H][f]: oy Wout Lpad + fy f C
  int* xtab = ytab + H * f;                // [W][f]: ox Lpad + fx C
  int* ycnt = xtab + W * f;                // [H]
  int* xcnt = ycnt + H;                    // [W]
  if (tables) {
    for (int t = tid; t < H + W; t += blockDim.x) {
      const bool row = t < H;
      const int v = row ? t : t - H;
      const int lim = row ? Hout : Wout;
      int* tab = (row ? ytab : xtab) + v * f;
      int cnt = 0;
      for (int k = 0; k < f; ++k) {
        const int rv = v - k * dilation;
        if (rv < 0) break;
        if (rv % stride) continue;
        const int o = rv / stride;
        if (o >= lim) continue;
        tab[cnt++] = row ? o * Wout * Lpad + k * f * C : o * Lpad + k * C;
      }
      if (row) ycnt[v] = cnt; else xcnt[v] = cnt;
    }
    __syncthreads();
  }
  float* di = dimg + static_cast<size_t>(n) * HWC;
  for (int t = tid; t < H * W * nch; t += blockDim.x) {
    const int pix = t / nch;
    const int c = rank + S * (t - pix * nch);
    const int xx = pix % W, yy = pix / W;
    float s = 0.0f;
    if (tables) {
      for (int a = 0; a < ycnt[yy]; ++a) {
        const float* row = Xs + ytab[yy * f + a] + c;
        for (int b = 0; b < xcnt[xx]; ++b) s += row[xtab[xx * f + b]];
      }
    } else {
      for (int fy = 0; fy < f; ++fy) {
        const int ry = yy - fy * dilation;
        if (ry < 0) break;
        if (ry % stride) continue;
        const int oy = ry / stride;
        if (oy >= Hout) continue;
        for (int fx = 0; fx < f; ++fx) {
          const int rx = xx - fx * dilation;
          if (rx < 0) break;
          if (rx % stride) continue;
          const int ox = rx / stride;
          if (ox >= Wout) continue;
          s += Xs[(oy * Wout + ox) * Lpad + (fy * f + fx) * C + c];
        }
      }
    }
    di[pix * C + c] = s;
  }

  K5_STAMP(9);
  dvar_acc = warp_sum(dvar_acc);
  dgam_acc = warp_sum(dgam_acc);
  if (lane == 0) {
    red[w] = dvar_acc;
    red[kMaxWarps + w] = dgam_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < nwarps; ++i) {
      s1 += red[i];
      s2 += red[kMaxWarps + i];
    }
    part[pbase + 2 * P] = s1 / var;
    part[pbase + 2 * P + 1] = s2;
  }
  for (int p = tid; p < P; p += blockDim.x)
    part[pbase + P + p] = 2.0f * dd * inv_p2 * dws[p];
}


// The Z side's k-chunk: 16 rows of the flattened (image, patch) axis.
// A block's tile is 128 rows of Z by 64 patch elements; 8 warps, 4 x 2,
// each 32 x 32 (2 x 4 mma tiles).  T [k][m] and the gathered patches
// [k][l] stream through a three-stage cp.async ring and are split once,
// by the thread that staged them, into double-buffered float2 tiles.
__global__ void __launch_bounds__(kZThreads) bwd_z_kernel(
    const float* __restrict__ img, const float* __restrict__ Z,
    const float* __restrict__ Tg, float* __restrict__ dZ, int N, int H,
    int W, int C, int f, int stride, int dilation, int Hout, int Wout, int M,
    int Mpad) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Traw = smem;                                  // [kZStages][kZKC][kZTM]
  float2* Ts = reinterpret_cast<float2*>(Traw + kZStages * kZKC * kZTM);
                                                       // [2][kZKC][kZLdT]
  float2* Xs = Ts + 2 * kZKC * kZLdT;                  // [2][kZKC][kZLdX]
  float* Rt = smem;                                    // [kZTM][kZLdR]: the
                                                       //   block's T^T patches
  float* csum = smem + kZPipeFloats;                   // [kZTM]: its colsum T
  float* cpart = csum + kZTM;                          // [8][kZTM]
  int* loffs = reinterpret_cast<int*>(cpart + 8 * kZTM);  // [kZTL]

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = Hout * Wout;
  const int L = f * f * C;
  const int HWC = H * W * C;
  const int mt = Mpad / kZTM;
  const int tile = blockIdx.x / S;
  const int m0 = (tile % mt) * kZTM, l0 = (tile / mt) * kZTL;
  const int K = N * P;   // rows of T [N P, Mpad]: far below 2^31
  const int nkc = (K + kZKC - 1) / kZKC;
  const int cpr = (nkc + S - 1) / S;
  const int c0 = rank * cpr;
  const int nk = max(0, min(nkc, c0 + cpr) - c0);

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wr = w >> 1, wc = w & 1;           // 32 rows of Z, 32 columns
  const int tk = tid >> 5, tm = 4 * (tid & 31);  // T: rows tk, tk + 8
  const int xk = tid >> 4, xl = tid & 15;  // patches: row xk, columns
                                           //   xl + 16 j

  for (int t = tid; t < kZTL; t += kZThreads) {
    const int l = l0 + t;
    loffs[t] = l < L ? patch_offset(l, f, C, W, dilation) : -1;
  }
  __syncthreads();

  // Issue the rows of T of k-chunk c into ring slot c % kZStages, 16
  // bytes a copy, as one group.
  auto stage = [&](int c) {
    float* Tr = Traw + (c % kZStages) * kZKC * kZTM;
    const int kb = (c0 + c) * kZKC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kb + tk + 8 * h;
      cp_async16z(Tr + (tk + 8 * h) * kZTM + tm,
                  k < K ? Tg + static_cast<size_t>(k) * Mpad + m0 + tm : Tg,
                  k < K);
    }
    cp_async_commit();
  };

  // Load this thread's patch elements of k-chunk c into registers: a
  // half-warp reads 16 consecutive elements of one patch row (runs of
  // f C contiguous floats in the image).  Loads, not 4-byte cp.async:
  // those made the gather the Z side's largest cost.
  float xv[4];
  auto load_x = [&](int c) {
    const int k = (c0 + c) * kZKC + xk;
    long long base = -1;
    if (k < K) {
      const int n = k / P, p = k - n * P;
      const int oy = p / Wout, ox = p - oy * Wout;
      base = static_cast<long long>(n) * HWC + (oy * stride * W + ox * stride) * C;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lo = loffs[xl + 16 * j];
      xv[j] = base >= 0 && lo >= 0 ? __ldg(img + base + lo) : 0.0f;
    }
  };

  // Split this thread's own elements of chunk c -- its staged T, whose
  // values it adds into colsum T, and its loaded patch elements -- into
  // the float2 tiles [c & 1].
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto convert = [&](int c) {
    const float* Tr = Traw + (c % kZStages) * kZKC * kZTM;
    float2* Td = Ts + (c & 1) * kZKC * kZLdT;
    float2* Xd = Xs + (c & 1) * kZKC * kZLdX;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(Tr + (tk + 8 * h) * kZTM + tm);
      cs[0] += v.x;
      cs[1] += v.y;
      cs[2] += v.z;
      cs[3] += v.w;
      split_store4(Td + (tk + 8 * h) * kZLdT + tm, v);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Xd[xk * kZLdX + xl + 16 * j] = split_tf32(xv[j]);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // The ring: T of chunk c + kZStages - 1 is issued before chunk c is
  // computed, chunk c + 1 is awaited and split after it, so three chunks
  // of products cover each copy's latency; one barrier a chunk.
  if (nk > 0) {
#pragma unroll
    for (int c = 0; c < kZStages - 1; ++c) {
      if (c < nk) {
        stage(c);
      } else {
        cp_async_commit();
      }
    }
    load_x(0);
    cp_async_wait<kZStages - 2>();
    convert(0);
    if (nk > 1) load_x(1);
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      if (c + kZStages - 1 < nk) {
        stage(c + kZStages - 1);
      } else {
        cp_async_commit();
      }
      const float2* A = Ts + (c & 1) * kZKC * kZLdT;  // A[m][k] = T[k][m]
      const float2* B = Xs + (c & 1) * kZKC * kZLdX;  // B[k][l]
#pragma unroll
      for (int ks = 0; ks < kZKC; ks += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2* a = A + (ks + t4) * kZLdT + wr * 32 + i * 16 + g8;
          const float2 x0 = a[0], x1 = a[8], x2 = a[4 * kZLdT], x3 = a[4 * kZLdT + 8];
          ah[i][0] = __float_as_uint(x0.x);
          al[i][0] = __float_as_uint(x0.y);
          ah[i][1] = __float_as_uint(x1.x);
          al[i][1] = __float_as_uint(x1.y);
          ah[i][2] = __float_as_uint(x2.x);
          al[i][2] = __float_as_uint(x2.y);
          ah[i][3] = __float_as_uint(x3.x);
          al[i][3] = __float_as_uint(x3.y);
        }
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2* b = B + (ks + t4) * kZLdX + wc * 32 + j * 8 + g8;
          const float2 b0 = b[0], b1 = b[4 * kZLdX];
          bh[j][0] = __float_as_uint(b0.x);
          bl[j][0] = __float_as_uint(b0.y);
          bh[j][1] = __float_as_uint(b1.x);
          bl[j][1] = __float_as_uint(b1.y);
        }
        // The three passes over the eight tiles one after another, so
        // that no mma waits on the one before it.
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t(&a)[4] = pass == 0 ? al[i] : ah[i];
              const uint32_t(&b)[2] = pass == 1 ? bl[j] : bh[j];
              mma_tf32(acc[i][j], a, b[0], b[1]);
            }
      }
      cp_async_wait<kZStages - 2>();  // this thread's copies of chunk c + 1
      if (c + 1 < nk) convert(c + 1);
      if (c + 2 < nk) load_x(c + 2);   // a whole chunk covers their latency
      __syncthreads();
    }
    cp_async_wait<0>();
    __syncthreads();               // every copy has landed: Rt aliases the ring
  }

  // The block's part: T^T patches into Rt, colsum T over its rows.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wr * 32 + i * 16 + g8 + 8 * h;
        const int l = wc * 32 + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(Rt + m * kZLdR + l) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
#pragma unroll
  for (int j = 0; j < 4; ++j) cpart[tk * kZTM + tm + j] = cs[j];
  __syncthreads();
  if (tid < kZTM) {
    float s = 0.0f;
    for (int q = 0; q < 8; ++q) s += cpart[q * kZTM + tid];
    csum[tid] = s;
  }
  cluster.sync();                  // every rank's part is written

  // Rank r sums the rows m = r, r + S, ... of the tile over the cluster,
  // in rank order, and writes them: dZ = 2 (Z colsum T - T^T patches).
  const int own = (kZTM - rank + S - 1) / S;
  for (int e = tid; e < own * kZTL; e += kZThreads) {
    const int mm = rank + S * (e / kZTL), ll = e % kZTL;
    float v = 0.0f, c = 0.0f;
    for (int q = 0; q < S; ++q) {
      v += cluster.map_shared_rank(Rt, q)[mm * kZLdR + ll];
      c += cluster.map_shared_rank(csum, q)[mm];
    }
    const int m = m0 + mm, l = l0 + ll;
    if (m < M && l < L) {
      const size_t i = static_cast<size_t>(m) * L + l;
      dZ[i] = 2.0f * (Z[i] * c - v);
    }
  }
  cluster.sync();                  // no rank reads another's memory after this
}

// ---------------------------------------------------------------------------
// The image side in row tiles, for P > 64 (bwd_image_kernel_tiled).
//
// The cluster kernel above needs a whole image's patches and its P x P
// gram S in one block's shared memory, and two warps per 8 patch rows:
// P <= 64.  At the MNIST ConvKernel's geometry (28 x 28 images, f = 5:
// P = 576, L = 25; M = 1024) the gram alone would take 1.3 MB, and one
// cluster an image would leave most of the card idle at N = 32.
//
// What bounds it there: writing T, not the products.  At N = 32 the cross
// terms are 2 N P M L = 0.94 GFLOP and the gram's tile pairs p-tile <=
// q-tile ~0.3 GFLOP: 3 x 1.25 GFLOP as split-TF32 tensor-core products,
// ~0.008 ms at 495 TFLOP/s, ~0.012 ms at mma.sync's ~310; T [N, P, Mpad]
// is 75.5 MB, 0.0225 ms at 3.35 TB/s; the exponentials, N P (M + P / 2)
// = 24 M, ~0.007 ms on the SFU.
//
// Design: the work is dealt out in units, one block a unit, so that it
// spreads over the card (at N = 32: 32 x 5 x 8 = 1,280 cross units and
// 32 x 15 gram units):
//  - blockIdx.x the unit, blockIdx.y the image.  Units 0 .. R T - 1 are
//    the cross terms of a 128-row tile of the image's patches (R tiles)
//    by a 128-column tile of M (T tiles); the rest, with Kdiag, the gram's
//    tile pairs a <= b, numbered row by row.  The cross and gram units of
//    one image sit next to each other in launch order, so the gram leaves
//    no tail.
//  - The products are K4's (csrc/conv_rbf_cross.cu): split-TF32
//    mma.sync.m16n8k8, 8 warps of 32 x 64, k-chunks of 16 patch elements
//    through a three-stage cp.async ring, the patch rows gathered from the
//    image (im2col fused), Z's rows from the padded Zp, the row norms from
//    the fragments; a diagonal gram pair reads its columns from its rows.
//  - The epilogue works on the accumulator fragments: the exponential,
//    the masks, T (stored to Tg by float2) and, per unit, the partials of
//    du (a row tile's), dwkd (the rows of tile a, and of tile b for an
//    off-diagonal pair, which counts both entries of each of its pairs),
//    dvar and dgamma, summed across lanes by shuffles and across warps in
//    a fixed order.  Each partial goes to a slot of its own in device
//    memory (du [N, R, T, 128], dwkd [N, R, R, 128]: slot [a][b] holds
//    tile b's share of tile a's rows; scalars [N, units, 2]), and the
//    wrapper sums the slots in a fixed order: no atomics, the same bits
//    every run.
//  - The image gradient only when asked (DX).  The unit then puts its
//    tile of T, or of S, into shared memory (in the ring's space) and
//    forms its share of dpatches, T Z or (S + S^T) patches, on the tensor
//    cores in split TF32 again: 128 rows by 32 patch elements at a time
//    over 16-row chunks of Z (or of the partner tile's patches), into
//    slot [tile][unit's column] of [N, R, T + R, 128, Lx], with the row
//    sums beside them.  bwd_image_kernel_col2im then sums each element's
//    slots in order, adds the row-sum term and col2im's by a gather.
// The Z side (bwd_z_kernel) splits over the N P rows of T and takes any P.

constexpr int kTR = 128;        // patch rows of a row tile
constexpr int kTC = 128;        // columns of a tile: inducing points or patches
constexpr int kTKC = 16;        // patch elements a k-chunk
constexpr int kTStages = 3;     // cp.async ring depth
constexpr int kTThreads = 256;
constexpr int kTLdA = kTKC + 4;   // raw patch rows: conflict-free fragments
constexpr int kTLdB = kTKC + 4;   // split columns (float2): the same
constexpr int kTLdE = kTC + 4;    // the tile of T or S
constexpr int kTArawFloats = kTStages * kTR * kTLdA;
constexpr int kTBrawFloats = kTStages * kTC * kTKC;
constexpr int kTBsFloats = 2 * kTC * kTLdB * 2;
constexpr int kTPipeFloats = kTArawFloats + kTBrawFloats + kTBsFloats;
constexpr int kXL = 32;           // dpatches: patch elements a product chunk
constexpr int kXK = 16;           // dpatches: rows of B a k-chunk
constexpr int kXLd = kXL + 4;     // its split tile (float2): conflict-free
static_assert(kTR * kTLdE + kXK * kXL + 2 * kXK * kXLd <= kTPipeFloats,
              "the tile of T or S and the dpatches staging alias the ring");
// The ring, Z's (or the partner tile's) norms, row sums [2 kinds][2 warps]
// [128], column sums [2 kinds][4 warps][128], the row tables [2][128] and
// the warps' scalars.
constexpr int kTSmemFloats =
    kTPipeFloats + kTC + 4 * kTR + 8 * kTC + 2 * kTR + 16;

struct TGeo {
  int H, W, C, f, stride, dilation, Hout, Wout, P, L, HWC;
};

// 4 bytes, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async4z(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void split_u(float x, uint32_t& hi, uint32_t& lo) {
  const float2 s = split_tf32(x);
  hi = __float_as_uint(s.x);
  lo = __float_as_uint(s.y);
}

// Offset of patch element l (TF order: fy, fx, c) from its patch's first.
__device__ __forceinline__ int element_offset(const TGeo& g, int l) {
  const int fC = g.f * g.C;
  const int fy = l / fC, rem = l - fy * fC;
  const int fx = rem / g.C;
  return (fy * g.dilation * g.W + fx * g.dilation) * g.C + rem - fx * g.C;
}

// Bit 8 i + j: the warp's m-tile i (rows r0 + 16 i) and n-tile j (columns
// c0 + 8 j) hold a row and a column within the tile.  Warp-uniform.
__device__ __forceinline__ uint32_t tile_mask(int rows, int cols, int r0,
                                              int c0) {
  uint32_t mask = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 8; ++j)
      if (r0 + 16 * i < rows && c0 + 8 * j < cols) mask |= 1u << (8 * i + j);
  return mask;
}

// One k-step (8 patch elements) of a warp's 32 x 64 tile (K4's kstep):
// four n-tiles at a time, the three passes over their eight tiles one
// after another.  B comes from the split float2 tile or, for a diagonal
// gram pair (SELF), from the raw patch rows, split here.
template <bool MASKED, bool SELF>
__device__ __forceinline__ void tile_kstep(float (&acc)[2][8][4],
                                           const uint32_t (&ah)[2][4],
                                           const uint32_t (&al)[2][4],
                                           const float* A, const float2* B,
                                           int ks, int c0, int g8, int t4,
                                           uint32_t need) {
#pragma unroll
  for (int jh = 0; jh < 8; jh += 4) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = c0 + (jh + jj) * 8 + g8;
      if (SELF) {
        const float* b = A + col * kTLdA + ks + t4;
        split_u(b[0], bh[jj][0], bl[jj][0]);
        split_u(b[4], bh[jj][1], bl[jj][1]);
      } else {
        const float2* b = B + col * kTLdB + ks + t4;
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

template <bool DX>
__global__ void __launch_bounds__(kTThreads, 2) bwd_image_kernel_tiled(
    const float* __restrict__ img, const float* __restrict__ Zp,
    const float* __restrict__ scal, const float* __restrict__ u,
    const float* __restrict__ wkd, const float* __restrict__ dkzx,
    const float* __restrict__ dkd, float* __restrict__ Tg,
    float* __restrict__ sc, float* __restrict__ dup, float* __restrict__ dwp,
    float* __restrict__ rx, float* __restrict__ rsum, TGeo geo, int M,
    int Mpad, int Lpad, int Lx, int with_kdiag) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Araw = smem;                        // [kTStages][kTR][kTLdA]
  float* Braw = Araw + kTArawFloats;         // [kTStages][kTC][kTKC]
  float2* Bs = reinterpret_cast<float2*>(Braw + kTBrawFloats);  // [2][kTC][kTLdB]
  float* E = smem;                           // [kTR][kTLdE], after the ring
  float* Xraw = E + kTR * kTLdE;             // [kXK][kXL]
  float2* Xs = reinterpret_cast<float2*>(Xraw + kXK * kXL);  // [kXK][kXLd]
  float* bn = smem + kTPipeFloats;           // [kTC]: column-row norms
  float* rsm = bn + kTC;                     // [2 kinds][2 wc][kTR]
  float* csm = rsm + 4 * kTR;                // [2 kinds][4 wr][kTC]
  int* roff = reinterpret_cast<int*>(csm + 8 * kTC);  // [2][kTR]: tile a's
                                             //   and tile b's rows' offsets
  float* red = reinterpret_cast<float*>(roff + 2 * kTR);  // [2][8]

  const int tid = threadIdx.x;
  const int w = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;   // fragment row, column
  const int wr = w >> 1, wc = w & 1;         // 32-row, 64-column warp tile
  const int sr = tid >> 2, sq = tid & 3;     // Z: rows sr, sr + 64
  const int hr = tid >> 4, hk = tid & 15;    // patches: rows hr + 16 i
  const int P = geo.P, L = geo.L;
  const int n = blockIdx.y;
  const int unit = blockIdx.x;
  const int nrt = (P + kTR - 1) / kTR;
  const int nmt = Mpad / kTC;
  const int nslot = nmt + (with_kdiag ? nrt : 0);
  const bool gram = unit >= nrt * nmt;
  int ta, tb, mt = 0;                        // row tile, gram column tile
  if (!gram) {
    ta = tb = unit / nmt;
    mt = unit - ta * nmt;
  } else {
    int t = unit - nrt * nmt;
    ta = 0;
    while (t >= nrt - ta) {
      t -= nrt - ta;
      ++ta;
    }
    tb = ta + t;
  }
  const bool self = gram && ta == tb;        // the columns are the rows
  const int m0 = mt * kTC;
  const int rows = min(kTR, P - ta * kTR);
  const int cols = gram ? min(kTC, P - tb * kTC) : min(kTC, M - m0);
  const float var = scal[0], gamma = scal[1];
  const int nk = (L + kTKC - 1) / kTKC;
  const float inv_p2 = 1.0f / (static_cast<float>(P) * static_cast<float>(P));
  const float* x = img + static_cast<size_t>(n) * geo.HWC;

  for (int r = tid; r < 2 * kTR; r += kTThreads) {
    const int p = (r < kTR ? ta : tb) * kTR + (r & (kTR - 1));
    int off = -1;
    if (p < P) {
      const int oy = p / geo.Wout, ox = p - oy * geo.Wout;
      off = (oy * geo.stride * geo.W + ox * geo.stride) * geo.C;
    }
    roff[r] = off;
  }
  if (gram && !self)
    for (int r = tid; r < kTC; r += kTThreads) bn[r] = 0.0f;
  __syncthreads();
  const uint32_t need = tile_mask(rows, cols, wr * 32, wc * 64);

  // Issue k-chunk c into ring slot c % kTStages, as one group (K4's).
  auto stage = [&](int c) {
    const int slot = c % kTStages;
    float* As = Araw + slot * kTR * kTLdA;
    float* Br = Braw + slot * kTC * kTKC;
    const int k = c * kTKC + hk;
    const bool kv = k < L;
    const int lo = kv ? element_offset(geo, k) : 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = hr + 16 * i;
      const int ra = roff[r];
      const bool va = kv && ra >= 0;
      cp_async4z(As + r * kTLdA + hk, va ? x + ra + lo : x, va);
      if (gram && !self) {
        const int rb = roff[kTR + r];
        const bool vb = kv && rb >= 0;
        cp_async4z(Br + r * kTKC + hk, vb ? x + rb + lo : x, vb);
      }
    }
    if (!gram) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = sr + 64 * i;
        cp_async16(Br + r * kTKC + 4 * sq,
                   Zp + static_cast<size_t>(m0 + r) * Lpad + c * kTKC + 4 * sq);
      }
    }
    cp_async_commit();
  };

  // Split this thread's own staged columns of chunk c into Bs[c & 1] and
  // add up their squared norms (K4's).
  float bnacc[2] = {0.0f, 0.0f};
  auto convert = [&](int c) {
    const float* Br = Braw + (c % kTStages) * kTC * kTKC;
    float2* Bd = Bs + (c & 1) * kTC * kTLdB;
    if (self) return;
    if (gram) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = hr + 16 * i;
        const float v = Br[r * kTKC + hk];
        Bd[r * kTLdB + hk] = split_tf32(v);
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
      const float4 v = *reinterpret_cast<const float4*>(Br + r * kTKC + 4 * sq);
      bnacc[i] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      split_store4(Bd + r * kTLdB + 4 * sq, v);
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

  // The ring (K4's): chunk c + 2 is issued before chunk c is computed, and
  // chunk c + 1 is awaited and split after it; one barrier a chunk.
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
    const float* A = Araw + (c % kTStages) * kTR * kTLdA;
    const float2* B = Bs + (c & 1) * kTC * kTLdB;
#pragma unroll
    for (int ks = 0; ks < kTKC; ks += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = A + (wr * 32 + i * 16 + g8) * kTLdA + ks + t4;
        const float x0 = a[0], x1 = a[8 * kTLdA], x2 = a[4],
                    x3 = a[8 * kTLdA + 4];
        pnacc[i][0] += x0 * x0 + x2 * x2;
        pnacc[i][1] += x1 * x1 + x3 * x3;
        split_u(x0, ah[i][0], al[i][0]);
        split_u(x1, ah[i][1], al[i][1]);
        split_u(x2, ah[i][2], al[i][2]);
        split_u(x3, ah[i][3], al[i][3]);
      }
      const int c0 = wc * 64;
      if (self) {
        if (need == 0xFFFFu)
          tile_kstep<false, true>(acc, ah, al, A, B, ks, c0, g8, t4, need);
        else
          tile_kstep<true, true>(acc, ah, al, A, B, ks, c0, g8, t4, need);
      } else if (need == 0xFFFFu) {
        tile_kstep<false, false>(acc, ah, al, A, B, ks, c0, g8, t4, need);
      } else {
        tile_kstep<true, false>(acc, ah, al, A, B, ks, c0, g8, t4, need);
      }
    }
    cp_async_wait<1>();        // this thread's copies of chunk c + 1
    if (c + 1 < nk) convert(c + 1);
    __syncthreads();
  }
  cp_async_wait<0>();

  // Norms: a row's four stagers, a fragment row's four lanes; a diagonal
  // gram pair takes its column norms from its rows'.
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
  __syncthreads();             // bn written; every copy has landed: E may
                               //   take the ring's space

  float dvar_acc = 0.0f, dgam_acc = 0.0f;
  if (!gram) {
    // T = gamma u_p dKzx K [D > 0] on the unit's 128 x 128 cross terms; the
    // row sums of dKzx K (du) and of T (for dpatches).
    float a[8][2], zc[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wc * 64 + j * 8 + 2 * t4 + e;
        const int m = m0 + col;
        a[j][e] = m < M ? __ldg(dkzx + static_cast<size_t>(n) * M + m) : 0.0f;
        zc[j][e] = bn[col];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr * 32 + i * 16 + g8 + 8 * h;
        const int p = ta * kTR + r;
        const bool valid = r < rows;
        const float up = valid ? __ldg(u + p) : 0.0f;
        float du = 0.0f, rt = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float tv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d2 = pnacc[i][h] + zc[j][e] - 2.0f * acc[i][j][2 * h + e];
            const float dh = fmaxf(d2, 0.0f);
            const float ak = a[j][e] * (var * expf(gamma * dh));
            const float auk = up * ak;
            dvar_acc += auk;
            dgam_acc += auk * dh;
            const float t = d2 > 0.0f ? auk * gamma : 0.0f;
            du += ak;
            rt += t;
            tv[e] = t;
          }
          const int col = wc * 64 + j * 8 + 2 * t4;
          if (valid)
            *reinterpret_cast<float2*>(
                Tg + (static_cast<size_t>(n) * P + p) * Mpad + m0 + col) =
                make_float2(tv[0], tv[1]);
          if (DX)
            *reinterpret_cast<float2*>(E + r * kTLdE + col) =
                make_float2(tv[0], tv[1]);
        }
        if (!valid) du = 0.0f;
        du += __shfl_xor_sync(0xffffffffu, du, 1);
        du += __shfl_xor_sync(0xffffffffu, du, 2);
        rt += __shfl_xor_sync(0xffffffffu, rt, 1);
        rt += __shfl_xor_sync(0xffffffffu, rt, 2);
        if (t4 == 0) {
          rsm[wc * kTR + r] = du;
          rsm[(2 + wc) * kTR + r] = rt;
        }
      }
  } else {
    // The gram pair's terms: base = dKdiag w_p w_q Kd / P^2, S = gamma base
    // [E > 0]; an off-diagonal pair counts each of its entries twice, as
    // (p, q) and (q, p).  Row sums of w_q Kd (dwkd of tile a) and of S;
    // column sums of w_p Kd (dwkd of tile b) and of S.
    const float dd = dkd[n];
    const float mult = self ? 1.0f : 2.0f;
    float wq[8][2], cw[8][2], cs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wc * 64 + j * 8 + 2 * t4 + e;
        wq[j][e] = c < cols ? __ldg(wkd + tb * kTC + c) : 0.0f;
        cw[j][e] = cs[j][e] = 0.0f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr * 32 + i * 16 + g8 + 8 * h;
        const bool valid = r < rows;
        const float wp = valid ? __ldg(wkd + ta * kTR + r) : 0.0f;
        float rw = 0.0f, rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float sv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = wc * 64 + j * 8 + 2 * t4 + e;
            const bool ok = valid && c < cols;
            const float e2 = pnacc[i][h] + bn[c] - 2.0f * acc[i][j][2 * h + e];
            const float eh = fmaxf(e2, 0.0f);
            const float kd = ok ? var * expf(gamma * eh) : 0.0f;
            const float base = dd * (wp * wq[j][e]) * inv_p2 * kd;
            dvar_acc += mult * base;
            dgam_acc += mult * base * eh;
            const float s = e2 > 0.0f ? base * gamma : 0.0f;
            rw += wq[j][e] * kd;
            cw[j][e] += wp * kd;
            rs += s;
            cs[j][e] += s;
            sv[e] = s;
          }
          if (DX)
            *reinterpret_cast<float2*>(E + r * kTLdE + wc * 64 + j * 8 + 2 * t4) =
                make_float2(sv[0], sv[1]);
        }
        rw += __shfl_xor_sync(0xffffffffu, rw, 1);
        rw += __shfl_xor_sync(0xffffffffu, rw, 2);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        if (t4 == 0) {
          rsm[wc * kTR + r] = rw;
          rsm[(2 + wc) * kTR + r] = rs;
        }
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = cw[j][e], v1 = cs[j][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          v0 += __shfl_xor_sync(0xffffffffu, v0, o);
          v1 += __shfl_xor_sync(0xffffffffu, v1, o);
        }
        if (g8 == 0) {
          const int c = wc * 64 + j * 8 + 2 * t4 + e;
          csm[wr * kTC + c] = v0;
          csm[(4 + wr) * kTC + c] = v1;
        }
      }
  }

  // The unit's partials, each into a slot of its own.
  dvar_acc = warp_sum(dvar_acc);
  dgam_acc = warp_sum(dgam_acc);
  if (lane == 0) {
    red[w] = dvar_acc;
    red[8 + w] = dgam_acc;
  }
  __syncthreads();             // red, rsm, csm and E are complete
  if (tid == 0) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < 8; ++i) {
      s1 += red[i];
      s2 += red[8 + i];
    }
    const size_t o = (static_cast<size_t>(n) * gridDim.x + unit) * 2;
    sc[o] = s1;
    sc[o + 1] = s2;
  }
  const float fw = gram ? 2.0f * dkd[n] * inv_p2 : 0.0f;
  const size_t rowslot =
      (static_cast<size_t>(n) * nrt + ta) * nslot + (gram ? nmt + tb : mt);
  if (tid < kTR) {
    const int r = tid;
    const bool valid = r < rows;
    const float v0 = rsm[r] + rsm[kTR + r];
    if (!gram)
      dup[((static_cast<size_t>(n) * nrt + ta) * nmt + mt) * kTR + r] =
          valid ? v0 : 0.0f;
    else
      dwp[((static_cast<size_t>(n) * nrt + ta) * nrt + tb) * kTR + r] =
          valid ? fw * v0 : 0.0f;
    if (DX) {
      float v1 = rsm[2 * kTR + r] + rsm[3 * kTR + r];
      if (self)                // row sums of S + S^T
        v1 += csm[4 * kTC + r] + csm[5 * kTC + r] + csm[6 * kTC + r] +
              csm[7 * kTC + r];
      else if (gram)
        v1 *= 2.0f;
      rsum[rowslot * kTR + r] = valid ? v1 : 0.0f;
    }
  } else if (gram && !self) {
    const int c = tid - kTR;
    const bool valid = c < cols;
    const float v0 = csm[c] + csm[kTC + c] + csm[2 * kTC + c] + csm[3 * kTC + c];
    dwp[((static_cast<size_t>(n) * nrt + tb) * nrt + ta) * kTR + c] =
        valid ? fw * v0 : 0.0f;
    if (DX) {
      const float v1 = csm[4 * kTC + c] + csm[5 * kTC + c] + csm[6 * kTC + c] +
                       csm[7 * kTC + c];
      rsum[((static_cast<size_t>(n) * nrt + tb) * nslot + nmt + ta) * kTR + c] =
          valid ? 2.0f * v1 : 0.0f;
    }
  }
  if (!DX) return;

  // dpatches: the tile's share, out[r][l] = scale sum_k A[r][k] B[k][l]
  // with A = E (or E^T) and B's rows Z's m0 + k (or the patch rows of the
  // table at rbase), in split TF32, 32 patch elements at a time.
  if (self) {                  // S + S^T in place
    for (int i = tid; i < kTR * kTR; i += kTThreads) {
      const int r = i / kTR, c = i - r * kTR;
      if (r < c) {
        const float s = E[r * kTLdE + c] + E[c * kTLdE + r];
        E[r * kTLdE + c] = s;
        E[c * kTLdE + r] = s;
      } else if (r == c) {
        E[r * kTLdE + r] *= 2.0f;
      }
    }
    __syncthreads();
  }
  auto product = [&](bool trans, int rbase, float scale, float* out) {
    for (int l0 = 0; l0 < Lx; l0 += kXL) {
      float oc[2][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) oc[i][j][e] = 0.0f;
      for (int k0 = 0; k0 < kTC; k0 += kXK) {
        for (int e = tid; e < kXK * kXL; e += kTThreads) {
          const int kr = e / kXL, l = l0 + e - kr * kXL;
          if (!gram) {
            cp_async4z(Xraw + e,
                       Zp + static_cast<size_t>(m0 + k0 + kr) * Lpad + l, true);
          } else {
            const int ro = roff[rbase + k0 + kr];
            const bool v = ro >= 0 && l < L;
            cp_async4z(Xraw + e, v ? x + ro + element_offset(geo, l) : x, v);
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int e = tid; e < kXK * kXL; e += kTThreads) {
          const int kr = e / kXL;
          Xs[kr * kXLd + e - kr * kXL] = split_tf32(Xraw[e]);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kXK; ks += 8) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wr * 32 + i * 16 + g8, k = k0 + ks + t4;
            const float v[4] = {
                trans ? E[k * kTLdE + r] : E[r * kTLdE + k],
                trans ? E[k * kTLdE + r + 8] : E[(r + 8) * kTLdE + k],
                trans ? E[(k + 4) * kTLdE + r] : E[r * kTLdE + k + 4],
                trans ? E[(k + 4) * kTLdE + r + 8] : E[(r + 8) * kTLdE + k + 4]};
#pragma unroll
            for (int q = 0; q < 4; ++q) split_u(v[q], ah[i][q], al[i][q]);
          }
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2* b = Xs + (ks + t4) * kXLd + wc * 16 + j * 8 + g8;
            const float2 b0 = b[0], b1 = b[4 * kXLd];
            bh[j][0] = __float_as_uint(b0.x);
            bl[j][0] = __float_as_uint(b0.y);
            bh[j][1] = __float_as_uint(b1.x);
            bl[j][1] = __float_as_uint(b1.y);
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int i = 0; i < 2; ++i)
                mma_tf32(oc[i][j], pass == 0 ? al[i] : ah[i],
                         pass == 1 ? bl[j][0] : bh[j][0],
                         pass == 1 ? bl[j][1] : bh[j][1]);
        }
        __syncthreads();       // Xraw and Xs are refilled next
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int r = wr * 32 + i * 16 + g8 + 8 * h;
            const int l = l0 + wc * 16 + j * 8 + 2 * t4;
            *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * Lx + l) =
                make_float2(scale * oc[i][j][2 * h],
                            scale * oc[i][j][2 * h + 1]);
          }
    }
  };
  const size_t tile = static_cast<size_t>(kTR) * Lx;
  // Tile a's rows: T Z, (S + S^T) patches_a, or 2 S patches_b.
  product(false, self ? 0 : kTR, gram && !self ? 2.0f : 1.0f,
          rx + rowslot * tile);
  if (gram && !self)           // tile b's rows: 2 S^T patches_a
    product(true, 0, 2.0f,
            rx + ((static_cast<size_t>(n) * nrt + tb) * nslot + nmt + ta) *
                     tile);
}

// d images of the row-tiled image side: each pixel gathers the patch
// elements that read it, each the sum of its slots of rx in slot order
// (times -2) plus 2 x its row sums: the same order every run.
__global__ void __launch_bounds__(256) bwd_image_kernel_col2im(
    const float* __restrict__ img, const float* __restrict__ rx,
    const float* __restrict__ rsum, float* __restrict__ dimg, TGeo geo,
    int N, int nrt, int nslot, int Lx) {
  const size_t total = static_cast<size_t>(N) * geo.HWC;
  for (size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(t / geo.HWC);
    const int rem = static_cast<int>(t - static_cast<size_t>(n) * geo.HWC);
    const int pix = rem / geo.C, c = rem - pix * geo.C;
    const int yy = pix / geo.W, xx = pix - yy * geo.W;
    const float xv = img[t];
    float s = 0.0f;
    for (int fy = 0; fy < geo.f; ++fy) {
      const int ry = yy - fy * geo.dilation;
      if (ry < 0) break;
      if (ry % geo.stride) continue;
      const int oy = ry / geo.stride;
      if (oy >= geo.Hout) continue;
      for (int fx = 0; fx < geo.f; ++fx) {
        const int rxx = xx - fx * geo.dilation;
        if (rxx < 0) break;
        if (rxx % geo.stride) continue;
        const int ox = rxx / geo.stride;
        if (ox >= geo.Wout) continue;
        const int p = oy * geo.Wout + ox;
        const int l = (fy * geo.f + fx) * geo.C + c;
        const size_t base =
            (static_cast<size_t>(n) * nrt + p / kTR) * nslot * kTR + p % kTR;
        float v = 0.0f, rs = 0.0f;
        for (int q = 0; q < nslot; ++q) {
          v += rx[(base + static_cast<size_t>(q) * kTR) * Lx + l];
          rs += rsum[base + static_cast<size_t>(q) * kTR];
        }
        s += -2.0f * v + 2.0f * xv * rs;
      }
    }
    dimg[t] = s;
  }
}

TGeo tiled_geo(int H, int W, int C, int f, int stride, int dilation) {
  TGeo g;
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
  return g;
}


// Opt in to more dynamic shared memory than a launch gets by default, once
// per device, kernel and size: the attribute keeps the largest size set.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t* opted) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) opted[dev] = smem;
  return err;
}

template <int NLT, bool WIDE>
int launch_image(const float* img, const float* Zt, const float* Zp,
                 const float* zn, const float* scal, const float* u, const float* wkd,
                 const float* dkzx, const float* dkd, float* Tg, float* part,
                 float* dimg, int N, int H, int W, int C, int f, int stride,
                 int dilation, int Hout, int Wout, int M, int Mpad,
                 int with_kdiag, size_t smem, long long* trace,
                 cudaStream_t stream) {
  static size_t opted[kMaxDevices] = {};
  cudaError_t err = opt_in(bwd_image_kernel<NLT, WIDE>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = image_cluster(Mpad);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * S);
  cfg.blockDim = dim3(64 * (padded_rows(Hout * Wout) / kRows));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_image_kernel<NLT, WIDE>, img, Zt, Zp,
                           zn, scal, u, wkd, dkzx, dkd, Tg, part, dimg, H, W, C,
                           f, stride, dilation, Hout, Wout, M, Mpad,
                           with_kdiag, trace);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the image side the card holds at once at this geometry, or
// minus the CUDA error.
template <int NLT, bool WIDE>
int max_clusters(int P, int S, size_t smem) {
  static size_t opted[kMaxDevices] = {};
  cudaError_t err = opt_in(bwd_image_kernel<NLT, WIDE>, smem, opted);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S);
  cfg.blockDim = dim3(64 * (padded_rows(P) / kRows));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, bwd_image_kernel<NLT, WIDE>,
                                       &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

void out_dims(int H, int W, int f, int stride, int dilation, int* Hout,
              int* Wout) {
  const int eff = (f - 1) * dilation + 1;
  *Hout = (H - eff) / stride + 1;
  *Wout = (W - eff) / stride + 1;
}

}  // namespace

// Dynamic shared memory of one image-side block; the caller refuses
// geometries above the card's per-block limit, P > 64 or L > 512.
extern "C" size_t conv_rbf_cross_bwd_image_smem_bytes(int P, int L) {
  const size_t Ppad = padded_rows(P);
  const size_t Lpad = (L + kMT - 1) / kMT * kMT;
  const size_t tiles = kMT * Ppad > Ppad * Lpad ? kMT * Ppad : Ppad * Lpad;
  const size_t floats = L * Ppad + tiles + 2 * kStage + Ppad * (Ppad + 1) +
                        8 * Ppad + 2 * kMaxWarps;
  return floats * sizeof(float);
}

// Image-side clusters of S = min(Mpad / 128, 8) blocks
// resident on the card at once for patch count P and length L (P <= 64,
// L <= 512), or minus the CUDA error.
extern "C" int conv_rbf_cross_bwd_image_max_clusters(int P, int L, int Mpad) {
  const size_t smem = conv_rbf_cross_bwd_image_smem_bytes(P, L);
  const int S = image_cluster(Mpad);
  const int nlt = (L + kMT - 1) / kMT;
  if (!image_wide(P, L))
    return nlt == 1 ? max_clusters<1, false>(P, S, smem)
                    : max_clusters<2, false>(P, S, smem);
  switch (nlt) {
    case 1: return max_clusters<1, true>(P, S, smem);
    case 2: return max_clusters<2, true>(P, S, smem);
    case 3: return max_clusters<3, true>(P, S, smem);
    default: return max_clusters<4, true>(P, S, smem);
  }
}

extern "C" size_t conv_rbf_cross_bwd_z_smem_bytes() {
  return kZSmemFloats * sizeof(float);
}

// Image side.  img [N, H, W, C]; Zt [L, Mpad] = Z^T and Zp [Mpad, Lpad] = Z,
// both zero-padded (Mpad a multiple of 128, Lpad = 128 ceil(L / 128)), and
// zn [Mpad] the squared norms of Z's rows;
// scal [2] = (variance, gamma); u, wkd [P] in TF patch order; dkzx [N, M];
// dkd [N] (read only when with_kdiag).  Writes T into Tg [N, P, Mpad], the
// partials part [N, S, 2P + 2] = (du [P], dwkd [P], dvar, dgamma) of each
// image's S = min(Mpad / 128, 8) blocks, and dimg
// [N, H, W, C].  Launches on `stream`, allocates nothing, returns the
// first CUDA error.  The traced form also writes clock64() at ten phase
// boundaries of the middle block's thread 0 into trace [10].
static int image_side(
    const float* img, const float* Zt, const float* Zp, const float* zn,
    const float* scal,
    const float* u, const float* wkd, const float* dkzx, const float* dkd,
    float* Tg, float* part, float* dimg, int N, int H, int W, int C, int f,
    int stride, int dilation, int M, int Mpad, int with_kdiag,
    long long* trace, void* stream) {
  int Hout, Wout;
  out_dims(H, W, f, stride, dilation, &Hout, &Wout);
  const int P = Hout * Wout;
  const int L = f * f * C;
  if (P < 1 || padded_rows(P) > kRows * kMaxWarps / 2 || L > 4 * kMT ||
      Mpad % kMT || Mpad < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = conv_rbf_cross_bwd_image_smem_bytes(P, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nlt = (L + kMT - 1) / kMT;
#define K5_IMAGE(NLT, WIDE)                                                  \
  launch_image<NLT, WIDE>(img, Zt, Zp, zn, scal, u, wkd, dkzx, dkd, Tg, part, \
                            dimg, N, H, W, C, f, stride, dilation, Hout,    \
                            Wout, M, Mpad, with_kdiag, smem, trace, s)
  if (!image_wide(P, L))
    return nlt == 1 ? K5_IMAGE(1, false) : K5_IMAGE(2, false);
  switch (nlt) {
    case 1: return K5_IMAGE(1, true);
    case 2: return K5_IMAGE(2, true);
    case 3: return K5_IMAGE(3, true);
    default: return K5_IMAGE(4, true);
  }
#undef K5_IMAGE
}

extern "C" int conv_rbf_cross_bwd_image(
    const float* img, const float* Zt, const float* Zp, const float* zn,
    const float* scal,
    const float* u, const float* wkd, const float* dkzx, const float* dkd,
    float* Tg, float* part, float* dimg, int N, int H, int W, int C, int f,
    int stride, int dilation, int M, int Mpad, int with_kdiag, void* stream) {
  return image_side(img, Zt, Zp, zn, scal, u, wkd, dkzx, dkd, Tg, part, dimg, N,
                    H, W, C, f, stride, dilation, M, Mpad, with_kdiag, nullptr,
                    stream);
}

extern "C" int conv_rbf_cross_bwd_image_traced(
    const float* img, const float* Zt, const float* Zp, const float* zn,
    const float* scal,
    const float* u, const float* wkd, const float* dkzx, const float* dkd,
    float* Tg, float* part, float* dimg, int N, int H, int W, int C, int f,
    int stride, int dilation, int M, int Mpad, int with_kdiag,
    long long* trace, void* stream) {
  return image_side(img, Zt, Zp, zn, scal, u, wkd, dkzx, dkd, Tg, part, dimg, N,
                    H, W, C, f, stride, dilation, M, Mpad, with_kdiag, trace,
                    stream);
}

// Z side.  img [N, H, W, C]; Z [M, L]; Tg [N, P, Mpad] from the image
// side (Mpad a multiple of 128).  Writes dZ [M, L]: a cluster of `cluster`
// blocks (1-16) per 128 x 64 tile, each over its share of the N P rows,
// summed over distributed shared memory in rank order, so dZ is the same
// bits every run.  Launches on `stream`, allocates nothing, returns the
// first CUDA error.
extern "C" int conv_rbf_cross_bwd_z(const float* img, const float* Z,
                                    const float* Tg, float* dZ, int N, int H,
                                    int W, int C, int f, int stride,
                                    int dilation, int M, int Mpad, int cluster,
                                    void* stream) {
  int Hout, Wout;
  out_dims(H, W, f, stride, dilation, &Hout, &Wout);
  const int L = f * f * C;
  if (N < 1 || Hout < 1 || Wout < 1 || Mpad % kZTM || Mpad < M ||
      cluster < 1 || cluster > kZMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = conv_rbf_cross_bwd_z_smem_bytes();
  static size_t opted[kMaxDevices] = {};
  cudaError_t err = opt_in(bwd_z_kernel, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {
    err = cudaFuncSetAttribute(bwd_z_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (Mpad / kZTM) * ((L + kZTL - 1) / kZTL);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(kZThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_z_kernel, img, Z, Tg, dZ, N, H, W, C, f,
                           stride, dilation, Hout, Wout, M, Mpad);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block of the row-tiled image side (the same
// at every geometry).
extern "C" size_t conv_rbf_cross_bwd_tiled_smem_bytes() {
  return kTSmemFloats * sizeof(float);
}

// Row-tiled image side, P > 64 (the caller refuses L > 512).  img
// [N, H, W, C]; Zp [Mpad, Lpad] = Z zero-padded (Mpad a multiple of 128,
// Lpad of 128); scal [2] = (variance, gamma); u, wkd [P] in TF patch
// order; dkzx [N, M]; dkd [N] (read only when with_kdiag).  Writes T into
// Tg [N, P, Mpad] and the units' partials: sc [N, units, 2] (sum of the
// terms of dvar times var, dgamma), dup [N, R, Mpad / 128, 128] (du),
// dwp [N, R, R, 128] (dwkd, with_kdiag only), with R = ceil(P / 128) row
// tiles and units = R Mpad / 128 (+ R (R + 1) / 2 with Kdiag); with
// with_dimg also rx [N, R, slots, 128, Lx] and rsum [N, R, slots, 128]
// (slots = Mpad / 128 (+ R with Kdiag), Lx a multiple of 32 >= L, <=
// Lpad), which conv_rbf_cross_bwd_image_tiled_col2im turns into d images.
// Launches on `stream`, allocates nothing, returns the first CUDA error.
extern "C" int conv_rbf_cross_bwd_image_tiled(
    const float* img, const float* Zp, const float* scal, const float* u,
    const float* wkd, const float* dkzx, const float* dkd, float* Tg,
    float* sc, float* dup, float* dwp, float* rx, float* rsum, int N, int H,
    int W, int C, int f, int stride, int dilation, int M, int Mpad, int Lpad,
    int Lx, int with_kdiag, int with_dimg, void* stream) {
  const TGeo g = tiled_geo(H, W, C, f, stride, dilation);
  if (N < 1 || N > 65535 || g.Hout < 1 || g.Wout < 1 || g.P <= 64 ||
      g.L > 4 * kTC || Mpad % kTC || Mpad < M || Lpad % kTC || Lpad < g.L ||
      (with_dimg && (Lx % kXL || Lx < g.L || Lx > Lpad)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = conv_rbf_cross_bwd_tiled_smem_bytes();
  const int nrt = (g.P + kTR - 1) / kTR;
  const int units = nrt * (Mpad / kTC) + (with_kdiag ? nrt * (nrt + 1) / 2 : 0);
  const dim3 grid(units, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_dimg) {
    static size_t opted[kMaxDevices] = {};
    err = opt_in(bwd_image_kernel_tiled<true>, smem, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_image_kernel_tiled<true><<<grid, kTThreads, smem, s>>>(
        img, Zp, scal, u, wkd, dkzx, dkd, Tg, sc, dup, dwp, rx, rsum, g, M,
        Mpad, Lpad, Lx, with_kdiag);
  } else {
    static size_t opted[kMaxDevices] = {};
    err = opt_in(bwd_image_kernel_tiled<false>, smem, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_image_kernel_tiled<false><<<grid, kTThreads, smem, s>>>(
        img, Zp, scal, u, wkd, dkzx, dkd, Tg, sc, dup, dwp, rx, rsum, g, M,
        Mpad, Lpad, Lx, with_kdiag);
  }
  return static_cast<int>(cudaGetLastError());
}

// d images [N, H, W, C] of the row-tiled image side from its rx and rsum
// (the layout above): one thread a pixel and channel, a gather.
extern "C" int conv_rbf_cross_bwd_image_tiled_col2im(
    const float* img, const float* rx, const float* rsum, float* dimg, int N,
    int H, int W, int C, int f, int stride, int dilation, int Mpad,
    int with_kdiag, int Lx, void* stream) {
  const TGeo g = tiled_geo(H, W, C, f, stride, dilation);
  if (N < 1 || g.Hout < 1 || g.Wout < 1 || Mpad % kTC || Lx % kXL ||
      Lx < g.L)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nrt = (g.P + kTR - 1) / kTR;
  const int nslot = Mpad / kTC + (with_kdiag ? nrt : 0);
  const size_t total = static_cast<size_t>(N) * g.HWC;
  const int blocks = static_cast<int>(
      (total + 255) / 256 < 65535 ? (total + 255) / 256 : 65535);
  bwd_image_kernel_col2im<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      img, rx, rsum, dimg, g, N, nrt, nslot, Lx);
  return static_cast<int>(cudaGetLastError());
}
