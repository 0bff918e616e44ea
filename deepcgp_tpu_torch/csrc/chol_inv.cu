// Batched Cholesky factors, in two forms:
//   chol_factor_blocked:  A [b, M, M] SPD -> L lower (L L^T = A) and the
//                         inverses of its M/32 diagonal 32x32 blocks, for
//                         M % 32 == 0 and M <= 1024 (K1);
//   chol_upper_blocked:   G [b, M, M] SPD, lower triangle read -> Lf lower
//                         with Lf Lf^T = J G J (J the index reversal, so
//                         R = J Lf J is G's upper factor, R R^T = G) and
//                         the inverses of Lf's diagonal 32x32 blocks, for
//                         M % 32 == 0 and M <= 2048 (K2).
//
// K1 replaces the TPU kernel `_chol_inv_base_kernel` together with the
// blocked drivers around it (`chol_inv_batched`, `chol_factor_batched`) in
// deepcgp_tpu/ops/pallas_linalg.py: the whole right-looking factorization
// of a matrix is one launch.  K2 replaces `_chol_inv_base_kernel_upper`
// (the Cholesky of the index-reversed matrix, without materializing the
// reverses) together with the NatGrad drivers around it
// (`chol_inv_batched_upper`, `chol_right_solve_upper`): K2 then K3
// (tri_inv.cu) give R^-1 = J Lf^-1 J.
//
// K1, panel k = 0 .. M/32 - 1 over the working matrix W (= A, then its
// Schur complements), in 32x32 tiles:
//   diagonal   L_kk = factor of W_kk                       (one warp)
//   panel      L_ik = W_ik L_kk^-T,             i > k      (one warp a tile)
//   downdate   W_ij -= L_ik L_jk^T,             i >= j > k (one warp a tile)
//   inverse    L_kk^-1, written beside L for K3 (tri_inv.cu)
// The diagonal factor runs its columns in blocks of 8: step j reads the
// pivot W[j][j], rsq = rsqrt(pivot), column j of L is W[j:, j] * rsq and
// the rows i > j update W[i][k] -= (W[i][j] * rsq) * rsq * W[j][k] over the
// block's columns k > j; a rank-8 update then folds the block into the
// columns right of it.  So the 8x8 sub-blocks on the diagonal are read
// whole (both triangles, after their downdates); everything else is read
// on and below the diagonal only.  The panel solve is forward substitution
// with L_kk (x_q = w_q * (1 / L_qq), then w_q' -= L_q'q x_q), and so is the
// inverse (on the identity's columns).  A non-positive pivot gives NaN
// (rsqrt of a negative number) that spreads through the rest of its matrix
// and never to another one: callers detect a failed factorization by its
// non-finite values.
//
// What bounds it on an H100: not bytes (8 M^2 per matrix) nor arithmetic
// (M^3/3 per matrix, 0.36 GFLOP at M = 1024), but the chain of M/32
// panels, each a diagonal factor, a panel solve and a barrier that every
// block of the matrix crosses.  Design:
// * one thread-block cluster per matrix (8 or 16 blocks on neighbouring
//   SMs), so a lone M = 1024 matrix works on 16 SMs, not 1; the blocks meet
//   at one cluster barrier a panel (barrier.cluster, release/acquire);
// * the first block runs the chain of diagonal tiles and nothing else, one
//   step ahead: in panel k's phase its first warp downdates tile k+1 with
//   panel k, factors it in registers (pivot entries by __shfl_sync, no
//   block barrier inside the 32 steps) and publishes it: L_dd^T with the
//   diagonal's reciprocals in the block's shared memory, then a flag set
//   in every block of the cluster; its other warps write L_dd^-1 meanwhile;
// * the other blocks' warps share panel k's downdate, one 32x32 tile at a
//   time in a fixed round-robin (a lane owns a 4x8 interleaved sub-tile: 32
//   FMAs per three 16-byte shared-memory reads, the tile's copy in flight
//   meanwhile); the warps that downdated column k+1's tiles fetch L_dd^T from
//   the first block (distributed shared memory) once it is flagged and
//   solve them before the barrier;
// * the working matrix stays in global memory (the L output buffer, 4 MB at
//   M = 1024, so L2-resident); every block stages the current panel (up to
//   31 tiles, 140 KB) in its shared memory once per panel, and every read
//   of data written inside the kernel bypasses L1 (cp.async.cg, ld.cg).
// The chain's steps are single warps, so what sets their time is
// instructions issued one after another: the diagonal factor leaves the
// inverse to the other warps, and the panel solve reads the diagonal's
// reciprocals instead of dividing.  tools/torch_chol_clusters.py stamps the
// chain's phases with clock64().  Full float32 FMA throughout; nothing
// uses the tensor cores.
//
// K2 runs K1's arithmetic, step for step, on J G J read from G's lower
// triangle: entry (r, c) of J G J is G[M-1-min(r,c)][M-1-max(r,c)], read
// tile by tile through shared memory (a warp stages the mirrored source
// tile and writes it out reversed), so nothing above G's diagonal is ever
// used and no reversed copy is made first.  Its output is bit-equal to
// K1's on J sym(G) J.  What changes is where the panel lives: K1 stages
// the whole current panel in every block (144 (M + 512) bytes, which ends
// at M = 1088), K2 spreads it over the cluster.
// * tile row i >= 1 belongs to worker block 1 + (i - 1) % (cluster - 1)
//   (cuda_linalg.upper_plan states the same ownership and budget); the
//   owner downdates every tile (i, j) of its rows and solves its column
//   tiles, so its rows' panel tiles stay in its own shared memory, in two
//   buffers by panel parity: a column tile (i, k+1) is downdated and
//   solved in place in the buffer of panel k+1 while panel k is read from
//   the other, so no panel is staged from global memory and the one
//   cluster barrier a panel also publishes the next one;
// * a warp reads the panel row j of a tile (i, j) from its owner through
//   distributed shared memory, copied once into the warp's own buffer for
//   a run of tiles of the same column (each block takes its triangle
//   column by column, in contiguous runs balanced over its warps);
// * the chain of diagonal tiles, the downdate micro-kernel, the tile
//   copies, the panel solve and the diagonal inverses are K1's functions.
// Shared memory: (2 ceil((M/32 - 1) / (cluster - 1)) + 17) * 4,608 bytes
// (124,416 at M = 2048 with 16 blocks a matrix, 161,280 with 8).  What
// bounds it is what bounds K1: in the first panels the workers'
// downdates (the 4x8 micro-kernel reads three 16-byte words of shared
// memory per 32 FMAs), in the last ones the chain (the diagonal tile's
// downdate, factor and publication, the column solves, the barrier);
// the copy of J G J into L takes ~3% (tools/torch_chol_clusters.py
// --k2-only stamps the phases).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------------ K1

constexpr int kW = 32;           // panel width: one warp, one lane a row
constexpr int kLd = 36;          // row stride of a staged tile (16-byte rows)
constexpr int kSub = 8;          // the diagonal factor's column blocks
constexpr int kWarps = 8;        // warps of a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxM = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The cluster barrier (arrive.release, wait.acquire): every block's
// stores before it, global ones included, are seen after it.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// A warp copies the 32x32 tile at G (row stride ld) into S (row stride kLd),
// asynchronously; the caller waits.
__device__ __forceinline__ void warp_tile_async(const float* G, int ld,
                                                float* S, int lane) {
#pragma unroll
  for (int e = lane; e < kW * 8; e += 32) {
    const int r = e >> 3, c = (e & 7) * 4;
    cp_async16(S + r * kLd + c, G + static_cast<size_t>(r) * ld + c);
  }
}

// A warp writes the 32x32 tile S (row stride kLd) to G (row stride ld).
__device__ __forceinline__ void warp_tile_store(const float* S, float* G,
                                                int ld, int lane) {
#pragma unroll
  for (int e = lane; e < kW * 8; e += 32) {
    const int r = e >> 3, c = (e & 7) * 4;
    __stcg(reinterpret_cast<float4*>(G + static_cast<size_t>(r) * ld + c),
           *reinterpret_cast<const float4*>(S + r * kLd + c));
  }
}

// acc[t][u] = sum_q A[g + 8t][q] * B[h + 4u][q] for lane = 4g + h, A and B
// 32x32 tiles in shared memory (row stride kLd): the lane's rows and
// columns interleave, so each 16-byte read is free of bank conflicts.
__device__ __forceinline__ void warp_tile_abt(const float* A, const float* B,
                                              float acc[4][8], int lane) {
  const int g = lane >> 2, h = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[t][u] = 0.0f;
#pragma unroll 2
  for (int q = 0; q < kW; q += 4) {
    float4 a[4], b[8];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      a[t] = *reinterpret_cast<const float4*>(A + (g + 8 * t) * kLd + q);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      b[u] = *reinterpret_cast<const float4*>(B + (h + 4 * u) * kLd + q);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float s = acc[t][u];
        s = fmaf(a[t].x, b[u].x, s);
        s = fmaf(a[t].y, b[u].y, s);
        s = fmaf(a[t].z, b[u].z, s);
        s = fmaf(a[t].w, b[u].w, s);
        acc[t][u] = s;
      }
  }
}

// S[g + 8t][h + 4u] -= acc[t][u]: the lane's 32 entries of a tile.
__device__ __forceinline__ void frag_subtract_from(const float acc[4][8],
                                                   float* S, int lane) {
  const int g = lane >> 2, h = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float* s = S + (g + 8 * t) * kLd + h + 4 * u;
      *s = *s - acc[t][u];
    }
}

// The downdate of one tile: S -= A B^T (all three in shared memory), the
// product taken while the caller's asynchronous copy into S lands.
__device__ __forceinline__ void warp_downdate(float* S, const float* A,
                                              const float* B, int lane) {
  float acc[4][8];
  warp_tile_abt(A, B, acc, lane);
  cp_async_wait_all();
  __syncwarp();
  frag_subtract_from(acc, S, lane);
  __syncwarp();
}

// One warp factors the 32x32 tile S (shared memory, row stride kLd) in
// place: lane i holds row i in registers; the columns go in blocks of 8,
// each eliminated step by step with the pivot row's live entries by
// __shfl_sync, then folded into the columns right of the block by one
// rank-8 update through the scratch P ([32][9]).  Step j of a block reads
// the pivot W[j][j], rsq = rsqrt(pivot); column j of L = W[j:, j] * rsq;
// the rows i > j update W[i][k] -= (W[i][j] * rsq) * rsq * W[j][k] for the
// block's columns k > j.  The 8x8 diagonal sub-blocks are read whole (both
// triangles), the rest of the tile on and below its diagonal.  Leaves L
// (zeros above its diagonal) in S, and L^T in LT with the reciprocals of
// the diagonal in its column 32 (LT[q][32] = 1 / L_qq).
__device__ void warp_factor_tile(float* S, float* P, float* LT, int lane) {
  const int i = lane;
  float a[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) a[k] = S[i * kLd + k];
#pragma unroll
  for (int b = 0; b < kW; b += kSub) {
#pragma unroll
    for (int j = b; j < b + kSub; ++j) {
      const float r = rsqrtf(__shfl_sync(kFull, a[j], j));
      const float m = (a[j] * r) * r;
      const bool below = i > j;
#pragma unroll
      for (int k = j + 1; k < b + kSub; ++k) {
        const float w = __shfl_sync(kFull, a[k], j);
        if (below) a[k] = fmaf(-m, w, a[k]);
      }
      a[j] = (i >= j) ? a[j] * r : 0.0f;
    }
    if (b + kSub < kW) {
#pragma unroll
      for (int p = 0; p < kSub; ++p) P[i * (kSub + 1) + p] = a[b + p];
      __syncwarp();
      if (i >= b + kSub) {
#pragma unroll
        for (int k = b + kSub; k < kW; ++k) {
          float s = 0.0f;
#pragma unroll
          for (int p = 0; p < kSub; ++p)
            s = fmaf(a[b + p], P[k * (kSub + 1) + p], s);
          a[k] -= s;
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int k = 0; k < kW; k += 4)
    *reinterpret_cast<float4*>(S + i * kLd + k) =
        make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]);
#pragma unroll
  for (int k = 0; k < kW; ++k) LT[k * kLd + i] = a[k];
  __syncwarp();
  LT[i * kLd + kW] = 1.0f / LT[i * kLd + i];
  __syncwarp();
}

// The panel solve of one tile by forward substitution: S (row stride kLd)
// <- S L^-T, L given as LT = L^T (row stride kLd, 1 / L_qq in column 32):
// lane r solves row r, x_q = w_q * (1 / L_qq), then w_q' -= L_q'q x_q for
// q' > q.  Written to G.
__device__ __forceinline__ void warp_panel_solve(float* S, const float* LT,
                                                 float* G, int ld, int lane) {
  float w[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) w[k] = S[lane * kLd + k];
#pragma unroll
  for (int q = 0; q < kW; ++q) {
    w[q] *= LT[q * kLd + kW];
#pragma unroll
    for (int k = (q + 1) / 4 * 4; k < kW; k += 4) {
      const float4 l = *reinterpret_cast<const float4*>(LT + q * kLd + k);
      if (k > q) w[k] = fmaf(-l.x, w[q], w[k]);
      if (k + 1 > q) w[k + 1] = fmaf(-l.y, w[q], w[k + 1]);
      if (k + 2 > q) w[k + 2] = fmaf(-l.z, w[q], w[k + 2]);
      if (k + 3 > q) w[k + 3] = fmaf(-l.w, w[q], w[k + 3]);
    }
  }
#pragma unroll
  for (int k = 0; k < kW; k += 4)
    *reinterpret_cast<float4*>(S + lane * kLd + k) =
        make_float4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  __syncwarp();
  warp_tile_store(S, G, ld, lane);
  __syncwarp();
}

// The first block's warps 1-7 write the diagonal tile's inverse (L in S)
// to Dg (row stride 32): warp w takes columns c = w-1, w+6, ... together,
// each by forward substitution on e_c, lane s holding row s:
// x_q *= 1 / L_qq, then x_s -= L_sq x_q for s > q.  Off the chain of
// panels: K3 (tri_inv.cu) takes these inverses.
__device__ void warps_diag_inverse(const float* S, float* Dg, int warp,
                                   int lane) {
  constexpr int kCols = (kW + kWarps - 2) / (kWarps - 1);
  float lrow[kW], x[kCols];
#pragma unroll
  for (int k = 0; k < kW; ++k) lrow[k] = S[lane * kLd + k];
  const float rd = 1.0f / S[lane * kLd + lane];
#pragma unroll
  for (int t = 0; t < kCols; ++t)
    x[t] = lane == warp - 1 + (kWarps - 1) * t ? 1.0f : 0.0f;
#pragma unroll
  for (int q = 0; q < kW; ++q) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      const float xq = __shfl_sync(kFull, x[t] * rd, q);
      if (lane == q) x[t] = xq;
      if (lane > q) x[t] = fmaf(-lrow[q], xq, x[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const int c = warp - 1 + (kWarps - 1) * t;
    if (c < kW) __stcg(Dg + lane * kW + c, x[t]);
  }
}

// The diagonal warp tells every block of the cluster that the factor tile
// in its block's `ldiag` belongs to `flag`: after a fence, it sets their
// `ready`.
__device__ __forceinline__ void warp_publish(int* ready, int flag, int lane) {
  cg::cluster_group cluster = cg::this_cluster();
  __threadfence();
  if (lane < static_cast<int>(cluster.num_blocks()))
    *reinterpret_cast<volatile int*>(cluster.map_shared_rank(ready, lane)) =
        flag;
}

// A warp waits until this block's `ready` reaches `flag`, then returns the
// diagonal factor tile (transposed) that the first block's `ldiag` holds:
// copied into `local` where given, else that buffer itself (distributed
// shared memory).
__device__ __forceinline__ const float* warp_fetch_ldiag(const int* ready,
                                                         int flag,
                                                         float* ldiag,
                                                         float* local,
                                                         int lane) {
  if (lane == 0)
    while (*reinterpret_cast<const volatile int*>(ready) < flag)
      __nanosleep(32);
  __syncwarp();
  __threadfence();
  const float* src = cg::this_cluster().map_shared_rank(ldiag, 0);
  if (local == nullptr) return src;
#pragma unroll
  for (int e = lane; e < kW * kLd / 4; e += 32)   // the reciprocals too
    reinterpret_cast<float4*>(local)[e] =
        reinterpret_cast<const float4*>(src)[e];
  __syncwarp();
  return local;
}

// The first block's share of panel k: its warp 0 downdates the diagonal
// tile d = k+1 with L_dk (read from L into `pbuf`), factors it in
// registers, publishes L_dd^T to the cluster and stores L_dd; its warps
// 1-7 then write L_dd^-1.  The chain of the factorization: K1 and K2 run
// it one panel ahead of the other blocks.  `at`: optional clock64() stamps.
__device__ __forceinline__ void chain_step(float* Lm, float* Dm, int M, int k,
                                           float* pbuf, float* slot0,
                                           float* scratch, float* ldiag,
                                           int* ready, int warp, int lane,
                                           long long* at) {
  const int d = k + 1;
  float* Ldd = Lm + static_cast<size_t>(d) * kW * M + d * kW;
  if (warp == 0) {
    if (at && lane == 0) at[0] = clock64();
    warp_tile_async(Lm + static_cast<size_t>(d) * kW * M + k * kW, M, pbuf,
                    lane);
    warp_tile_async(Ldd, M, slot0, lane);
    cp_async_wait_all();
    __syncwarp();
    warp_downdate(slot0, pbuf, pbuf, lane);
    if (at && lane == 0) at[1] = clock64();
    warp_factor_tile(slot0, scratch, ldiag, lane);
    if (at && lane == 0) at[3] = clock64();
    warp_publish(ready, d + 1, lane);
    if (at && lane == 0) at[4] = clock64();
    warp_tile_store(slot0, Ldd, M, lane);
    if (at && lane == 0) at[2] = clock64();
  }
  __syncthreads();
  if (warp > 0) warps_diag_inverse(slot0, Dm + d * kW * kW, warp, lane);
}

// The block stages L_00^T from L's tile (0, 0) in `ldiag`, with the
// diagonal's reciprocals in column 32: panel 0's solve.
__device__ __forceinline__ void block_stage_ldiag0(const float* Lm, int M,
                                                   float* ldiag) {
  for (int e = threadIdx.x; e < kW * 8; e += kThreads) {
    const int r = e >> 3, c = (e & 7) * 4;
    const float4 v = __ldcg(reinterpret_cast<const float4*>(Lm + r * M + c));
    ldiag[c * kLd + r] = v.x;
    ldiag[(c + 1) * kLd + r] = v.y;
    ldiag[(c + 2) * kLd + r] = v.z;
    ldiag[(c + 3) * kLd + r] = v.w;
  }
  __syncthreads();
  if (threadIdx.x < kW)
    ldiag[threadIdx.x * kLd + kW] = 1.0f / ldiag[threadIdx.x * kLd + threadIdx.x];
  __syncthreads();
}

// The row of entry u of a triangle whose row r holds r + 1 entries.
__device__ __forceinline__ int tri_row(int u) {
  int r = static_cast<int>((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > u) --r;
  while ((r + 1) * (r + 2) / 2 <= u) ++r;
  return r;
}

__global__ void __launch_bounds__(kThreads, 1)
    chol_factor_cluster_kernel(const float* __restrict__ A,
                               float* __restrict__ L, float* __restrict__ Dinv,
                               int M, long long* __restrict__ trace) {
  extern __shared__ __align__(16) float k1_smem[];
  __shared__ int ready;     // the diagonal tile last published here, + 1
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / csize;
  const int n = M / kW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The first block runs the chain of diagonal tiles; the other blocks'
  // warps share the downdates and the panel solves.
  const int me = (rank - 1) * kWarps + warp;
  const int nwork = (csize - 1) * kWarps;
  const size_t base = static_cast<size_t>(mat) * M * M;
  const float* Am = A + base;
  float* Lm = L + base;
  float* Dm = Dinv + static_cast<size_t>(mat) * n * kW * kW;

  float* panel = k1_smem;                                     // [M-32][kLd]
  float* slot = panel + (M - kW) * kLd + warp * 2 * kW * kLd;  // [32][kLd]
  float* held = slot + kW * kLd;                               // [32][kLd]
  float* ldiag = panel + (M - kW) * kLd + kWarps * 2 * kW * kLd;  // L_dd^T
  float* slot0 = panel + (M - kW) * kLd;      // the diagonal tile
  float* scratch = slot0 + kW * kLd;          // the factor's [32][9]
  auto tile = [&](float* P, int i, int j) {
    return P + static_cast<size_t>(i) * kW * M + j * kW;
  };
  // Optional clock64() stamps of the first cluster (chol_factor_blocked_traced).
  const bool tracer = trace != nullptr && blockIdx.x < 2;
  auto mark = [&](int at) {
    if (tracer && lane == 0) trace[at] = clock64();
  };
  if (threadIdx.x == 0) ready = 0;
  if (rank == 0 && threadIdx.x == 0) mark(0);

  // W = A on and below the diagonal tiles, L = 0 above them; the first
  // block factors tile (0, 0) straight from A meanwhile.
  if (rank == 0) {
    if (warp == 0) {
      warp_tile_async(Am, M, slot0, lane);
      cp_async_wait_all();
      __syncwarp();
      warp_factor_tile(slot0, scratch, ldiag, lane);
      warp_tile_store(slot0, Lm, M, lane);
    }
    __syncthreads();
    if (warp > 0) warps_diag_inverse(slot0, Dm, warp, lane);
  }
  const int vec_per_row = M / 4;
  for (int e = rank * kThreads + threadIdx.x; e < M * vec_per_row;
       e += csize * kThreads) {
    const int r = e / vec_per_row, c = (e % vec_per_row) * 4;
    const int ti = r / kW, tj = c / kW;
    if (ti == 0 && tj == 0) continue;
    const size_t off = static_cast<size_t>(r) * M + c;
    const float4 val = tj > ti ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : __ldg(reinterpret_cast<const float4*>(Am + off));
    __stcg(reinterpret_cast<float4*>(Lm + off), val);
  }
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) mark(1);
  if (n == 1) return;

  // Panel 0's solve, L_i0 = W_i0 L_00^-T, by the other blocks' warps
  // against L_00^T staged from the factor written above.
  if (rank > 0) {
    block_stage_ldiag0(Lm, M, ldiag);
    for (int t = me; t < n - 1; t += nwork) {
      warp_tile_async(tile(Lm, t + 1, 0), M, slot, lane);
      cp_async_wait_all();
      __syncwarp();
      warp_panel_solve(slot, ldiag, tile(Lm, t + 1, 0), M, lane);
    }
  }
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) mark(2);

  // Panel k: downdate the trailing tiles with L_{k+1:, k}.  Lookahead: the
  // first block downdates and factors tile d = k+1 at once and publishes
  // it; the warps that downdated column d's tiles solve them against it,
  // all before the one barrier of the panel.
  for (int k = 0; k + 1 < n; ++k) {
    long long* at = tracer ? trace + 8 + 10 * k : nullptr;
    const int d = k + 1;
    if (rank == 0) {
      chain_step(Lm, Dm, M, k, panel, slot0, scratch, ldiag, &ready, warp,
                 lane, at);
    } else {
      const int prow = M - (k + 1) * kW;
      for (int e = threadIdx.x; e < prow * 8; e += kThreads) {
        const int r = e >> 3, c = (e & 7) * 4;
        cp_async16(panel + r * kLd + c,
                   Lm + static_cast<size_t>((k + 1) * kW + r) * M + k * kW + c);
      }
      cp_async_wait_all();
      __syncthreads();
      const int ncol = n - d - 1;               // tiles (i, d), i > d
      bool holding = false;
      for (int c = me; c < ncol; c += nwork) {
        const int i = d + 1 + c;
        float* S = holding ? slot : held;
        warp_tile_async(tile(Lm, i, d), M, S, lane);
        warp_downdate(S, panel + (i - k - 1) * kW * kLd, panel, lane);
        if (holding)                // a second column tile: solve it now
          warp_panel_solve(S, warp_fetch_ldiag(&ready, d + 1, ldiag, nullptr,
                                               lane),
                           tile(Lm, i, d), M, lane);
        holding = true;
      }
      // The tiles (i, j), d < j <= i, after the column tiles in the
      // round-robin: entry u of the triangle is tile (d+1+r, d+1+u-r(r+1)/2).
      const int ntri = ncol * (ncol + 1) / 2;
      for (int u = ((me - ncol) % nwork + nwork) % nwork; u < ntri;
           u += nwork) {
        const int r = tri_row(u);
        const int i = d + 1 + r, j = d + 1 + u - r * (r + 1) / 2;
        float* Wij = tile(Lm, i, j);
        warp_tile_async(Wij, M, slot, lane);
        warp_downdate(slot, panel + (i - k - 1) * kW * kLd,
                      panel + (j - k - 1) * kW * kLd, lane);
        warp_tile_store(slot, Wij, M, lane);
        __syncwarp();
      }
      if (me < ncol) {
        if (at && me == 0 && lane == 0) at[6] = clock64();
        const float* LT = warp_fetch_ldiag(&ready, d + 1, ldiag, slot, lane);
        if (at && me == 0 && lane == 0) at[8] = clock64();
        warp_panel_solve(held, LT, tile(Lm, d + 1 + me, d), M, lane);
        if (at && me == 0 && lane == 0) at[5] = clock64();
      }
    }
    cluster_sync();
    if (at && rank == 0 && threadIdx.x == 0) at[7] = clock64();
  }
}

// ------------------------------------------------------------------ K2

constexpr int kMaxUpperM = 2048;
constexpr int kTile = kW * kLd;   // floats of a staged tile
constexpr size_t kMaxSmem = 232448;   // a block's opt-in shared memory

// A warp writes into T (row stride kLd) the 32x32 tile (ti, tj), ti >= tj,
// of J G J from G's lower triangle only: entry (r, c) of J G J is
// G[M-1-min(r,c)][M-1-max(r,c)].  The source, G's tile (n-1-tj, n-1-ti)
// on or below its diagonal, is staged in S by 16-byte copies and read
// back mirrored (lane c writes column c of a row).
__device__ void warp_tile_reversed(const float* Gm, int M, int ti, int tj,
                                   float* S, float* T, int lane) {
  warp_tile_async(Gm + static_cast<size_t>(M - kW * (tj + 1)) * M +
                      (M - kW * (ti + 1)),
                  M, S, lane);
  cp_async_wait_all();
  __syncwarp();
  const bool diag = ti == tj;
  const int c = lane;
#pragma unroll 4
  for (int r = 0; r < kW; ++r)
    T[r * kLd + c] = (diag && r < c) ? S[(kW - 1 - r) * kLd + kW - 1 - c]
                                     : S[(kW - 1 - c) * kLd + kW - 1 - r];
  __syncwarp();
}

// A warp writes zeros to the 32x32 tile at G (row stride ld).
__device__ __forceinline__ void warp_tile_zero(float* G, int ld, int lane) {
#pragma unroll
  for (int e = lane; e < kW * 8; e += 32) {
    const int r = e >> 3, c = (e & 7) * 4;
    __stcg(reinterpret_cast<float4*>(G + static_cast<size_t>(r) * ld + c),
           make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// A warp copies the staged tile at src (row stride kLd; another block's
// shared memory) into dst, 16 bytes a lane at a time, all loads first.
__device__ __forceinline__ void warp_tile_copy(const float* src, float* dst,
                                               int lane) {
  float4 v[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int e = lane + 32 * t, r = e >> 3, c = (e & 7) * 4;
    v[t] = *reinterpret_cast<const float4*>(src + r * kLd + c);
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int e = lane + 32 * t, r = e >> 3, c = (e & 7) * 4;
    *reinterpret_cast<float4*>(dst + r * kLd + c) = v[t];
  }
  __syncwarp();
}

// Worker rb (0-based: cluster rank rb + 1) of nw owns the tile rows
// rb + 1, rb + 1 + nw, ...: the first of them >= j, and how many lie in
// [j, n).
__device__ __forceinline__ int first_owned(int j, int rb, int nw) {
  return j + ((rb - (j - 1)) % nw + nw) % nw;
}

__device__ __forceinline__ int owned_from(int j, int n, int rb, int nw) {
  const int f = first_owned(j, rb, nw);
  return f < n ? (n - 1 - f) / nw + 1 : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
    chol_upper_cluster_kernel(const float* __restrict__ G,
                              float* __restrict__ L, float* __restrict__ Dinv,
                              int M, long long* __restrict__ trace) {
  extern __shared__ __align__(16) float k2_smem[];
  __shared__ int ready;     // the diagonal tile last published here, + 1
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / csize;
  const int n = M / kW;
  const int nw = csize - 1, rb = rank - 1;
  const int rows = (n - 1 + nw - 1) / nw;   // a worker's tile rows, at most
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(mat) * M * M;
  const float* Gm = G + base;
  float* Lm = L + base;
  float* Dm = Dinv + static_cast<size_t>(mat) * n * kW * kW;

  // Two panel buffers of this block's rows (panel k in buffer k & 1), then
  // two tiles a warp, then L_dd^T.  The first block's warp 0 takes its
  // slot for the diagonal tile, its rbuf for the factor's scratch.
  float* panels = k2_smem;
  float* warps = panels + 2 * rows * kTile;
  float* slot = warps + warp * 2 * kTile;   // a tile of W in flight
  float* rbuf = slot + kTile;               // a peer's panel row, or L_dd^T
  float* ldiag = warps + kWarps * 2 * kTile;
  float* slot0 = warps;
  float* scratch = warps + kTile;
  auto tile = [&](float* P, int i, int j) {
    return P + static_cast<size_t>(i) * kW * M + j * kW;
  };
  auto own = [&](int i) { return (i - 1) / nw * kTile; };
  // Optional clock64() stamps of the first cluster
  // (chol_upper_blocked_traced).
  const bool tracer = trace != nullptr && blockIdx.x < 2;
  if (threadIdx.x == 0) ready = 0;
  if (tracer && rank == 0 && threadIdx.x == 0) trace[0] = clock64();

  // Tile (0, 0) of J G J straight into the first block's factor (warp 1's
  // slot stages its source); meanwhile every warp writes J G J on and
  // below the diagonal tiles to L, zeros above them.
  if (rank == 0) {
    if (warp == 0) {
      warp_tile_reversed(Gm, M, 0, 0, warps + 2 * kTile, slot0, lane);
      warp_factor_tile(slot0, scratch, ldiag, lane);
      warp_tile_store(slot0, Lm, M, lane);
    }
    __syncthreads();
    if (warp > 0) warps_diag_inverse(slot0, Dm, warp, lane);
    __syncthreads();
  }
  for (int t = rank * kWarps + warp; t < n * n; t += csize * kWarps) {
    const int ti = t / n, tj = t % n;
    if (tj > ti) {
      warp_tile_zero(tile(Lm, ti, tj), M, lane);
    } else if (t > 0) {
      warp_tile_reversed(Gm, M, ti, tj, slot, rbuf, lane);
      warp_tile_store(rbuf, tile(Lm, ti, tj), M, lane);
      __syncwarp();
    }
  }
  cluster_sync();
  if (tracer && rank == 0 && threadIdx.x == 0) trace[1] = clock64();
  if (n == 1) return;

  // Panel 0's solve, L_i0 = W_i0 L_00^-T: each worker solves its own rows
  // into its buffer of panel 0.
  if (rank > 0) {
    block_stage_ldiag0(Lm, M, ldiag);
    for (int c = warp; c < owned_from(1, n, rb, nw); c += kWarps) {
      const int i = rb + 1 + c * nw;
      float* S = panels + c * kTile;
      warp_tile_async(tile(Lm, i, 0), M, S, lane);
      cp_async_wait_all();
      __syncwarp();
      warp_panel_solve(S, ldiag, tile(Lm, i, 0), M, lane);
    }
  }
  cluster_sync();
  if (tracer && rank == 0 && threadIdx.x == 0) trace[2] = clock64();

  // Panel k: the first block runs the chain (tile d = k+1 downdated,
  // factored and published); each worker downdates the tiles (i, j),
  // i >= j > k, of its rows i > k and solves its column tiles (i, d) in
  // place in its buffer of panel d, all before the one barrier of the
  // panel.
  for (int k = 0; k + 1 < n; ++k) {
    long long* at = tracer ? trace + 8 + 10 * k : nullptr;
    const int d = k + 1;
    if (rank == 0) {
      chain_step(Lm, Dm, M, k, panels, slot0, scratch, ldiag, &ready, warp,
                 lane, at);
    } else {
      const bool stamp = at && warp == 0 && lane == 0;
      if (stamp) at[9] = clock64();
      const float* Pk = panels + (k & 1) * rows * kTile;
      float* Pd = panels + (d & 1) * rows * kTile;
      // Panel row j of panel k: this block's own, or its owner's copied
      // once into rbuf for a run of tiles of column j.
      int copied = -1;
      auto prow = [&](int j) -> const float* {
        const int owner = 1 + (j - 1) % nw;
        const float* p = Pk + own(j);
        if (owner == rank) return p;
        if (copied != j) {
          warp_tile_copy(cluster.map_shared_rank(const_cast<float*>(p), owner),
                         rbuf, lane);
          copied = j;
        }
        return rbuf;
      };
      // The column tiles (i, d), i > d, a warp each in turn; held in place.
      const int f = first_owned(d + 1, rb, nw);
      const int ncol = owned_from(d + 1, n, rb, nw);
      for (int c = warp; c < ncol; c += kWarps) {
        const int i = f + c * nw;
        float* S = Pd + own(i);
        warp_tile_async(tile(Lm, i, d), M, S, lane);
        warp_downdate(S, Pk + own(i), prow(d), lane);
      }
      // The tiles (i, j), d < j <= i, column by column: a warp takes a
      // contiguous run, as many as the round-robin continuing after the
      // column tiles would give it.
      int ntri = 0;
      for (int j = d + 1; j < n; ++j) ntri += owned_from(j, n, rb, nw);
      auto share = [&](int w) {
        return (ncol + ntri - w + kWarps - 1) / kWarps -
               (ncol - w + kWarps - 1) / kWarps;
      };
      int skip = 0;
      for (int w = 0; w < warp; ++w) skip += share(w);
      int todo = share(warp);
      int j = d + 1;
      while (todo > 0 && skip >= owned_from(j, n, rb, nw)) {
        skip -= owned_from(j, n, rb, nw);
        ++j;
      }
      int i = first_owned(j, rb, nw) + skip * nw;
      for (; todo > 0; --todo, i += nw) {
        while (i >= n) i = first_owned(++j, rb, nw);
        float* Wij = tile(Lm, i, j);
        warp_tile_async(Wij, M, slot, lane);
        warp_downdate(slot, Pk + own(i), prow(j), lane);
        warp_tile_store(slot, Wij, M, lane);
        __syncwarp();
      }
      if (stamp) at[6] = clock64();
      if (warp < ncol) {
        const float* LT = warp_fetch_ldiag(&ready, d + 1, ldiag, rbuf, lane);
        if (stamp) at[8] = clock64();
        for (int c = warp; c < ncol; c += kWarps) {
          const int i = f + c * nw;
          warp_panel_solve(Pd + own(i), LT, tile(Lm, i, d), M, lane);
        }
        if (stamp) at[5] = clock64();
      }
    }
    cluster_sync();
    if (at && rank == 0 && threadIdx.x == 0) at[7] = clock64();
  }
}

}  // namespace

using ClusterKernel = void (*)(const float*, float*, float*, int, long long*);

// K1's dynamic shared memory: the panel and the warps' tiles,
// (M + 512) * 144 bytes (216 KB at M = 1024).
static size_t factor_smem(int M) {
  return sizeof(float) *
         (static_cast<size_t>(M - kW) + (2 * kWarps + 1) * kW) * kLd;
}

// K2's: two buffers of a worker's tile rows, two tiles a warp and L_dd^T,
// (2 ceil((M/32 - 1) / (cluster - 1)) + 17) * 4,608 bytes
// (cuda_linalg.upper_plan).
static size_t upper_smem(int M, int cluster) {
  const int rows = (M / kW - 1 + cluster - 2) / (cluster - 1);
  return sizeof(float) * kTile *
         (2 * static_cast<size_t>(rows) + 2 * kWarps + 1);
}

static cudaError_t cluster_attributes(ClusterKernel kernel, size_t smem,
                                      int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

static cudaLaunchConfig_t cluster_config(int blocks, size_t smem, int cluster,
                                         cudaLaunchAttribute* attr,
                                         void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of `kernel`, `cluster` blocks a matrix (2-8, or up to 16
// where the card allows non-portable clusters), on `stream`; returns the
// first CUDA error.
static int cluster_launch(ClusterKernel kernel, size_t smem, const float* A,
                          float* L, float* Dinv, int b, int M, int cluster,
                          long long* trace, void* stream) {
  cudaError_t err = cluster_attributes(kernel, smem, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(b * cluster, smem, cluster, attr, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, A, L, Dinv, M, trace);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The number of `cluster`-block clusters of `kernel` the card can hold at
// once (0: the launch would fail), or minus the CUDA error.
static int max_clusters(ClusterKernel kernel, size_t smem, int cluster) {
  cudaError_t err = cluster_attributes(kernel, smem, cluster);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, smem, cluster, attr, nullptr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// A, L: [b, M, M] and Dinv: [b, M/32, 32, 32], contiguous float32 on the
// device, M % 32 == 0 and 32 <= M <= 1024.  Allocates nothing.
static int factor_launch(const float* A, float* L, float* Dinv, int b, int M,
                         int cluster, long long* trace, void* stream) {
  if (M % kW || M < kW || M > kMaxM || cluster < 2 || cluster > 16 || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch(chol_factor_cluster_kernel, factor_smem(M), A, L,
                        Dinv, b, M, cluster, trace, stream);
}

// G, L: [b, M, M] and Dinv: [b, M/32, 32, 32], contiguous float32 on the
// device, M % 32 == 0 and 32 <= M <= 2048, and a cluster whose shared
// memory fits a block.  Only G's lower triangle is read.  Allocates
// nothing.
static int upper_launch(const float* G, float* L, float* Dinv, int b, int M,
                        int cluster, long long* trace, void* stream) {
  if (M % kW || M < kW || M > kMaxUpperM || cluster < 2 || cluster > 16 ||
      b < 1 || upper_smem(M, cluster) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch(chol_upper_cluster_kernel, upper_smem(M, cluster), G,
                        L, Dinv, b, M, cluster, trace, stream);
}

extern "C" int chol_factor_blocked(const float* A, float* L, float* Dinv,
                                   int b, int M, int cluster, void* stream) {
  return factor_launch(A, L, Dinv, b, M, cluster, nullptr, stream);
}

// chol_factor_blocked with clock64() stamps of the first cluster's phases
// written to `trace` (8 + 10 (M/32 - 1) values).
extern "C" int chol_factor_blocked_traced(const float* A, float* L,
                                          float* Dinv, int b, int M,
                                          int cluster, long long* trace,
                                          void* stream) {
  return factor_launch(A, L, Dinv, b, M, cluster, trace, stream);
}

// The number of `cluster`-block clusters of chol_factor_blocked at this M
// that the card can hold at once (0: the launch would fail), or minus the
// CUDA error.
extern "C" int chol_factor_max_clusters(int M, int cluster) {
  return max_clusters(chol_factor_cluster_kernel, factor_smem(M), cluster);
}

extern "C" int chol_upper_blocked(const float* G, float* L, float* Dinv,
                                  int b, int M, int cluster, void* stream) {
  return upper_launch(G, L, Dinv, b, M, cluster, nullptr, stream);
}

// chol_upper_blocked with clock64() stamps of the first cluster's phases
// written to `trace` (8 + 10 (M/32 - 1) values, K1's layout; the second
// block's warp 0 stamps a panel's start in slot 9 and the end of its
// downdates in slot 6).
extern "C" int chol_upper_blocked_traced(const float* G, float* L,
                                         float* Dinv, int b, int M,
                                         int cluster, long long* trace,
                                         void* stream) {
  return upper_launch(G, L, Dinv, b, M, cluster, trace, stream);
}

// The number of `cluster`-block clusters of chol_upper_blocked at this M
// that the card can hold at once (0: the launch would fail), or minus the
// CUDA error.
extern "C" int chol_upper_max_clusters(int M, int cluster) {
  return max_clusters(chol_upper_cluster_kernel, upper_smem(M, cluster),
                      cluster);
}
