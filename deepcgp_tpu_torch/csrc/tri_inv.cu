// Batched inverse of lower-triangular matrices: L [b, M, M] -> X = L^-1,
// M % 32 == 0 and M <= 2048, in one launch (K3).
//
// Replaces the TPU kernel `_tri_inv_base_kernel` in
// deepcgp_tpu/ops/pallas_linalg.py together with the block-doubling driver
// around it (`tri_inv_doubling`) and the block substitution of
// `chol_inv_batched`.  In 32x32 blocks, column block j of X is
//   X_jj = L_jj^-1,  X_ij = -L_ii^-1 sum_{j <= p < i} L_ip X_pj  (i > j),
// and no column of X depends on another.  L_ii^-1 is either given (the
// diagonal-block inverses K1 writes beside the factor, chol_inv.cu) and
// applied as a product, or, without them, applied by forward substitution
// on the 32x32 block: y_q = r_q * (1 / L_qq), then r_s -= L_sq y_q for
// s > q.
// A zero or non-finite diagonal gives inf/NaN in its own matrix only.
//
// What bounds it on an H100: not bytes (8 M^2 per matrix) nor arithmetic
// (M^3/3 per matrix), but the longest column's chain of M/32 block rows,
// each a product of depth up to M.  Design: one thread block per strip of
// 8 columns of one matrix, so the grid is b x M/8 blocks (128 at a lone
// M = 1024) and no block waits for another.  Strips are numbered longest
// first (strip 0 of every matrix, then strip 1, ...).  A block keeps its
// strip of X in shared memory, transposed; for block row i its 8 warps
// split the product over the 32x32 tiles L_ip, each warp streaming its
// tiles through a double buffer (cp.async) and holding a 4x2 interleaved
// sub-tile of the 32x8 sum per lane (4 k-steps: 32 FMAs per six 16-byte
// reads).  The warps' sums meet in shared memory in a fixed order, and the
// diagonal block's inverse (or substitution) finishes the block row.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 32;       // block of the diagonal inverses
constexpr int kS = 8;        // columns of a strip
constexpr int kLd = 36;      // row stride of a staged L tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;   // = kW * kS: one thread an entry
constexpr int kMaxM = 2048;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void warp_tile_async(const float* G, int ld,
                                                float* S, int lane) {
#pragma unroll
  for (int e = lane; e < kW * 8; e += 32) {
    const int r = e >> 3, c = (e & 7) * 4;
    cp_async16(S + r * kLd + c, G + static_cast<size_t>(r) * ld + c);
  }
}

__global__ void __launch_bounds__(kThreads)
    tri_inv_strip_kernel(const float* __restrict__ L,
                         const float* __restrict__ Dinv,
                         float* __restrict__ X, int M, int b) {
  extern __shared__ __align__(16) float k3_smem[];
  const int n = M / kW;
  const int strip = blockIdx.x / b, mat = blockIdx.x % b;
  const int c0 = strip * kS, j = c0 / kW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, h = lane & 3;
  const int ldx = M + 4;
  const size_t base = static_cast<size_t>(mat) * M * M;
  const float* Lm = L + base;
  float* Xm = X + base;
  const float* Dm =
      Dinv ? Dinv + static_cast<size_t>(mat) * n * kW * kW : nullptr;

  float* XT = k3_smem;                              // [kS][M + 4]: X^T strip
  float* buf = XT + kS * ldx + warp * 2 * kW * kLd;  // [2][32][kLd] a warp
  float* red = XT + kS * ldx + kWarps * 2 * kW * kLd;  // [kWarps][32][kS]
  float* Rs = red + kWarps * kW * kS;                // [32][kS]
  float* Ds = Rs + kW * kS;                          // [32][kLd]

  // Rows above the strip's diagonal block are zero.
  for (int e = tid; e < j * kW * kS; e += kThreads)
    Xm[static_cast<size_t>(e / kS) * M + c0 + e % kS] = 0.0f;

  const int r = tid / kS, c = tid % kS;   // this thread's entry of a block row
  for (int i = j; i < n; ++i) {
    if (Dm) {
      for (int e = tid; e < kW * 8; e += kThreads)
        cp_async16(Ds + (e >> 3) * kLd + (e & 7) * 4,
                   Dm + i * kW * kW + (e >> 3) * kW + (e & 7) * 4);
      cp_async_commit();
    }
    float rhs;
    if (i == j) {
      rhs = (i * kW + r == c0 + c) ? 1.0f : 0.0f;
    } else {
      // sum_p L_ip X_p over the tiles p = j + warp, j + warp + 8, ... < i.
      float acc[4][2] = {};
      const int tiles = (i - j - warp + kWarps - 1) / kWarps;
      const float* Li = Lm + static_cast<size_t>(i) * kW * M;
      if (tiles > 0) {
        warp_tile_async(Li + (j + warp) * kW, M, buf, lane);
        cp_async_commit();
      }
      for (int m = 0; m < tiles; ++m) {
        const int p = j + warp + m * kWarps;
        if (m + 1 < tiles) {
          warp_tile_async(Li + (p + kWarps) * kW, M,
                          buf + ((m + 1) & 1) * kW * kLd, lane);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const float* T = buf + (m & 1) * kW * kLd;
        const float* Xp = XT + p * kW;
#pragma unroll 2
        for (int q = 0; q < kW; q += 4) {
          float4 a[4], x[2];
#pragma unroll
          for (int t = 0; t < 4; ++t)
            a[t] = *reinterpret_cast<const float4*>(T + (g + 8 * t) * kLd + q);
#pragma unroll
          for (int u = 0; u < 2; ++u)
            x[u] = *reinterpret_cast<const float4*>(Xp + (h + 4 * u) * ldx + q);
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float s = acc[t][u];
              s = fmaf(a[t].x, x[u].x, s);
              s = fmaf(a[t].y, x[u].y, s);
              s = fmaf(a[t].z, x[u].z, s);
              s = fmaf(a[t].w, x[u].w, s);
              acc[t][u] = s;
            }
        }
        __syncwarp();
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          red[(warp * kW + g + 8 * t) * kS + h + 4 * u] = acc[t][u];
      __syncthreads();
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kW * kS + tid];
      rhs = -s;
    }
    cp_async_wait<0>();
    Rs[tid] = rhs;
    __syncthreads();

    if (Dm) {
      // X_i = L_ii^-1 rhs, a product with K1's inverse.
      float x = 0.0f;
#pragma unroll
      for (int q = 0; q < kW; ++q) x = fmaf(Ds[r * kLd + q], Rs[q * kS + c], x);
      XT[c * ldx + i * kW + r] = x;
      Xm[static_cast<size_t>(i * kW + r) * M + c0 + c] = x;
    } else {
      // Forward substitution on L_ii: warp w solves column w, lane s row s.
      const int s = lane, col = warp;
      float lrow[kW];
      const float* Lrow = Lm + static_cast<size_t>(i * kW + s) * M + i * kW;
#pragma unroll
      for (int q = 0; q < kW; q += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(Lrow + q));
        lrow[q] = v.x;
        lrow[q + 1] = v.y;
        lrow[q + 2] = v.z;
        lrow[q + 3] = v.w;
      }
      float y = Rs[s * kS + col];
#pragma unroll
      for (int q = 0; q < kW; ++q) {
        const float yq = __shfl_sync(kFull, y * (1.0f / lrow[q]), q);
        if (s == q) y = yq;
        if (s > q) y = fmaf(-lrow[q], yq, y);
      }
      XT[col * ldx + i * kW + s] = y;
      Xm[static_cast<size_t>(i * kW + s) * M + c0 + col] = y;
    }
    __syncthreads();
  }
}

}  // namespace

// L, X: [b, M, M] contiguous float32 on the device, M % 32 == 0 and
// 32 <= M <= 2048; Dinv: NULL, or the [b, M/32, 32, 32] inverses of L's
// diagonal blocks (K1's or K2's second output).  The strip of X, the
// warps' double buffers and the partial sums take (8 M + 21,920) * 4
// bytes of dynamic shared memory (118 KB at M = 1024, 153 KB at
// M = 2048).  Launches on `stream`, allocates nothing, and returns the
// first CUDA error.
extern "C" int tri_inv_blocked(const float* L, const float* Dinv, float* X,
                               int b, int M, void* stream) {
  if (M % kW || M < kW || M > kMaxM || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kS) * (M + 4) +
                       kWarps * 2 * kW * kLd + kWarps * kW * kS + kW * kS +
                       kW * kLd);
  const cudaError_t err = cudaFuncSetAttribute(
      tri_inv_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tri_inv_strip_kernel<<<b * (M / kS), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(L, Dinv, X, M,
                                                              b);
  return static_cast<int>(cudaGetLastError());
}
