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
//  1. image side, one thread-block cluster per image, one block per
//     128-column tile of M (S = Mpad / 128 blocks, at most 8; a block takes
//     the tiles rank, rank + S, ...), two warps per 8-row group, one a
//     64-column half of each tile.  A block holds the image's patch matrix
//     (transposed) in shared memory, streams its tile of Z through a
//     two-stage cp.async ring (8 KB a stage: 16 rows of Z^T for the cross
//     products, then whole rows of Z for T Z), recomputes its tile of the
//     cross-covariance (8 rows x 2 columns a lane), writes T [N, P, Mpad]
//     to device memory (17.7 MB at the flagship) and accumulates its part
//     of T Z in registers.  The image's gram is dealt out too: each block
//     takes the pairs p <= q whose index in the upper triangle is its rank
//     mod S (S is symmetric, so a pair gives both entries) and adds
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
    // E, Kd and S are symmetric (E[p,q] and E[q,p] are the same sums term
    // for term), so each pair gives both entries.
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
      const float eh = fmaxf(e, 0.0f);
      const float kd = var * expf(gamma * eh);
      const float base = dd * wkd[p] * wkd[q] * inv_p2 * kd;
      const float both = p == q ? base : 2.0f * base;
      dvar_acc += both;
      dgam_acc += both * eh;
      const float sv = e > 0.0f ? base * gamma : 0.0f;
      SS[p * Sp + q] = sv;
      SS[q * Sp + p] = sv;
      atomicAdd(&dws[p], wkd[q] * kd);
      if (p != q) atomicAdd(&dws[q], wkd[p] * kd);
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
