// Batched Cholesky factor plus its inverse: D [b, P, P] SPD ->
// (L, L^-1), L lower-triangular with L L^T = D.
//
// Replaces the TPU kernel `_chol_inv_base_kernel` in
// deepcgp_tpu/ops/pallas_linalg.py (the base case of `chol_inv_batched`).
// Same algorithm: Gaussian elimination on the augmented working matrix
// W = [D | I].  Step j reads the pivot W[j][j], and with
// rsq = rsqrt(pivot):
//   column j of L      = W[j:, j] * rsq
//   row j of L^-1      = W[j, P:] * rsq
//   rows i > j update  W[i, k] -= (W[i, j] * rsq) * rsq * W[j, k].
// A non-positive pivot gives NaN (rsqrt of a negative number) and the NaN
// spreads through the rest of that matrix, never to another batch element:
// callers detect a failed factorization by its non-finite values.
//
// What bounds it on an H100: not bytes (3 x 16 KB in, 2 x 3 x 16 KB out at
// the shipped b = 3, P = 64) nor arithmetic (~0.8 MFLOP), but the P-step
// serial chain: every step depends on the pivot the previous one wrote.
// Design: one thread block per matrix keeps its whole [P, 2P] working
// matrix in shared memory (32 KB at P = 64), so a step costs one barrier
// and a few shared-memory operations per thread; no global traffic inside
// the chain.  Each step touches only the live entries -- trailing left
// columns k > j and right columns k <= j (the rest of the right half is a
// structural zero) -- so no update races with a read of the pivot row or
// column.  A thread keeps one column slot for the whole chain, so it reads
// the pivot row once per step and divides no index inside the chain; the
// block is 1024 threads wide, so a step is at most four dependent
// shared-memory updates per thread -- with one block per SM nothing else
// hides their latency.  L
// and L^-1 are written once, coalesced, after the chain: column j of W and
// row j of W stop changing after step j.
// With b = 3 only 3 of the 132 SMs work; batching more matrices per call is
// the lever for a later change, not this one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void chol_inv_kernel(const float* __restrict__ D,
                                float* __restrict__ L,
                                float* __restrict__ Linv, int P) {
  extern __shared__ float smem[];
  const int P2 = 2 * P;
  float* W = smem;            // [P][2P]
  float* rsq = smem + P * P2;  // [P]
  const size_t base = static_cast<size_t>(blockIdx.x) * P * P;
  const float* Db = D + base;

  for (int t = threadIdx.x; t < P * P2; t += blockDim.x) {
    const int i = t / P2, k = t % P2;
    W[t] = (k < P) ? Db[i * P + k] : ((k - P) == i ? 1.0f : 0.0f);
  }
  __syncthreads();

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

}  // namespace

// D, L, Linv: [b, P, P] contiguous float32 on the device, P <= 64, so the
// working matrix (33 KB at P = 64) stays under the 48 KB of dynamic shared
// memory a launch gets without opting in.  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError().
extern "C" int chol_inv_base(const float* D, float* L, float* Linv, int b,
                             int P, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(P) * 2 * P + P);
  const int threads = P * (kThreads / P);
  chol_inv_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      D, L, Linv, P);
  return static_cast<int>(cudaGetLastError());
}
