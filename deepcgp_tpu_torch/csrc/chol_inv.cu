// Batched Cholesky factor plus its inverse, in two orientations:
//   chol_inv_base:        D [b, P, P] SPD -> (L, L^-1), L lower, L L^T = D;
//   chol_inv_base_upper:  D [b, P, P] SPD -> (R, R^-1), R upper, R R^T = D.
//
// Replace the TPU kernels `_chol_inv_base_kernel` (K1, the base case of
// `chol_inv_batched` / `chol_factor_batched`) and
// `_chol_inv_base_kernel_upper` (K2, the base case of the NatGrad drivers
// `chol_inv_batched_upper` / `chol_right_solve_upper`) in
// deepcgp_tpu/ops/pallas_linalg.py.  Same algorithm: Gaussian elimination on
// the augmented working matrix W = [D | I].  Lower: step j = 0 .. P-1 reads
// the pivot W[j][j], and with rsq = rsqrt(pivot):
//   column j of L      = W[j:, j] * rsq
//   row j of L^-1      = W[j, P:] * rsq
//   rows i > j update  W[i, k] -= (W[i, j] * rsq) * rsq * W[j, k].
// Upper: the same recurrence from the bottom-right corner, j = P-1 .. 0:
// column j of R = W[:j+1, j] * rsq, row j of R^-1 = W[j, P:] * rsq, and the
// rows i < j update -- the Cholesky of the index-reversed matrix, without
// reversing anything.
// Both read the WHOLE of D (the pivot row's entries right of / left of the
// diagonal feed the updates), as the TPU kernels do: a caller whose matrix
// is meaningful in one triangle only symmetrizes it first.
// A non-positive pivot gives NaN (rsqrt of a negative number) and the NaN
// spreads through the rest of that matrix, never to another batch element:
// callers detect a failed factorization by its non-finite values.
//
// What bounds it on an H100: not bytes (3 P^2 floats per matrix) nor
// arithmetic (~2P^3/3 per matrix), but the P-step serial chain: every step
// depends on the pivot the previous one wrote.  Design: one thread block
// per matrix keeps its whole [P, 2P] working matrix in shared memory (32 KB
// at P = 64, 128 KB at P = 128, above 48 KB by opting in), so a step costs
// one barrier and a few shared-memory operations per thread; no global
// traffic inside the chain.  Each step touches only the live entries --
// lower: trailing left columns k > j and right columns k <= j; upper:
// leading left columns k < j and right columns k >= j (the rest of the
// right half is a structural zero) -- exactly P columns, so no update races
// with a read of the pivot row or column.  A thread keeps one column slot
// for the whole chain, so it reads the pivot row once per step and divides
// no index inside the chain; the block is 1024 threads wide, so a step is at
// most P/8 dependent shared-memory updates per thread -- with one block per
// SM nothing else hides their latency.  The factor and the inverse are
// written once, coalesced, after the chain: column j and row j of W stop
// changing after step j.
// With b = 1-20 matrices only 1-20 of the 132 SMs work; batching more
// matrices per call is the lever for a later change, not this one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;

__device__ void load_augmented(const float* __restrict__ Db, float* W, int P) {
  const int P2 = 2 * P;
  for (int t = threadIdx.x; t < P * P2; t += blockDim.x) {
    const int i = t / P2, k = t % P2;
    W[t] = (k < P) ? Db[i * P + k] : ((k - P) == i ? 1.0f : 0.0f);
  }
  __syncthreads();
}

__global__ void chol_inv_kernel(const float* __restrict__ D,
                                float* __restrict__ L,
                                float* __restrict__ Linv, int P) {
  extern __shared__ float smem[];
  const int P2 = 2 * P;
  float* W = smem;            // [P][2P]
  float* rsq = smem + P * P2;  // [P]
  const size_t base = static_cast<size_t>(blockIdx.x) * P * P;
  load_augmented(D + base, W, P);

  // Each thread owns one live column slot c and every rstep-th row; the
  // block is a whole number of P-thread row groups.
  const int c = threadIdx.x % P;
  const int r0 = threadIdx.x / P;
  const int rstep = blockDim.x / P;
  for (int j = 0; j < P; ++j) {
    const float r = rsqrtf(W[j * P2 + j]);
    if (threadIdx.x == 0) rsq[j] = r;
    // Slot c maps the first P-1-j slots to the trailing left block
    // (k = j+1 .. P-1) and the other j+1 to the live right block
    // (k = P .. P+j).
    const int rows = P - 1 - j;
    const int k = (c < rows) ? (j + 1 + c) : (P + c - rows);
    const float wjk = W[j * P2 + k];
    for (int i = j + 1 + r0; i < P; i += rstep) {
      const float m = (W[i * P2 + j] * r) * r;
      W[i * P2 + k] -= m * wjk;
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < P * P; t += blockDim.x) {
    const int i = t / P, k = t % P;
    L[base + t] = (k <= i) ? W[i * P2 + k] * rsq[k] : 0.0f;
    Linv[base + t] = (k <= i) ? W[i * P2 + P + k] * rsq[i] : 0.0f;
  }
}

__global__ void chol_inv_upper_kernel(const float* __restrict__ D,
                                      float* __restrict__ R,
                                      float* __restrict__ Rinv, int P) {
  extern __shared__ float smem[];
  const int P2 = 2 * P;
  float* W = smem;            // [P][2P]
  float* rsq = smem + P * P2;  // [P]
  const size_t base = static_cast<size_t>(blockIdx.x) * P * P;
  load_augmented(D + base, W, P);

  const int c = threadIdx.x % P;
  const int r0 = threadIdx.x / P;
  const int rstep = blockDim.x / P;
  for (int j = P - 1; j >= 0; --j) {
    const float r = rsqrtf(W[j * P2 + j]);
    if (threadIdx.x == 0) rsq[j] = r;
    // Slots c < j are the leading left block (k = c), the other P-j the
    // live right block (k = P+j .. 2P-1, i.e. k = P + c).
    const int k = (c < j) ? c : (P + c);
    const float wjk = W[j * P2 + k];
    for (int i = r0; i < j; i += rstep) {
      const float m = (W[i * P2 + j] * r) * r;
      W[i * P2 + k] -= m * wjk;
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < P * P; t += blockDim.x) {
    const int i = t / P, k = t % P;
    R[base + t] = (k >= i) ? W[i * P2 + k] * rsq[k] : 0.0f;
    Rinv[base + t] = (k >= i) ? W[i * P2 + P + k] * rsq[i] : 0.0f;
  }
}

template <typename Kernel>
int launch(Kernel kernel, const float* D, float* F, float* Finv, int b, int P,
           void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(P) * 2 * P + P);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = P * (kThreads / P);
  kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(D, F, Finv,
                                                                   P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D, L, Linv: [b, P, P] contiguous float32 on the device, 0 < P <= 128; the
// working matrix (33 KB at P = 64, 129 KB at P = 128) opts in to more than
// the default 48 KB of dynamic shared memory where it needs to.  Launches
// on `stream`, allocates nothing, and returns the first CUDA error.
extern "C" int chol_inv_base(const float* D, float* L, float* Linv, int b,
                             int P, void* stream) {
  return launch(chol_inv_kernel, D, L, Linv, b, P, stream);
}

// The upper orientation, same contract: R upper with R R^T = D, Rinv = R^-1.
extern "C" int chol_inv_base_upper(const float* D, float* R, float* Rinv,
                                   int b, int P, void* stream) {
  return launch(chol_inv_upper_kernel, D, R, Rinv, b, P, stream);
}
