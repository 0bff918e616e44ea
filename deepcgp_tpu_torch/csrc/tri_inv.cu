// Batched inverse of lower-triangular matrices: L [b, P, P] -> X = L^-1.
//
// Replaces the TPU kernel `_tri_inv_base_kernel` (K3) in
// deepcgp_tpu/ops/pallas_linalg.py, the base case of `tri_inv_doubling`:
// the diagonal blocks of a large factor are inverted here in one launch and
// merged by matrix products outside.  Same mathematics, forward
// substitution: X[i, :] = (e_i - sum_{p<i} L[i, p] X[p, :]) / L[i, i].
// A zero or non-finite diagonal gives inf/NaN in its own matrix only.
//
// What bounds it on an H100: neither bytes (2 P^2 floats per matrix) nor
// arithmetic (P^3/3 per matrix), but the P-step dependency of each column's
// substitution.  Design: one thread block per matrix holds L and X^T in
// shared memory (64 KB + 68 KB at P = 128, above 48 KB by opting in).
// Columns of X are independent, so each column belongs to 8 consecutive
// lanes of one warp, which split every step's dot product 8 ways and
// reduce it with shuffles: a step needs only a warp-level sync, never a
// block barrier, so the four columns of a warp run on at their own pace.
// X is stored transposed with a row stride of P + 8 so that the 32 lanes of
// a warp (4 columns x 8 row offsets) hit 32 distinct banks; the reads of
// L's row i are broadcasts.  Column c skips its structural zeros (rows and
// terms above c).  At the shipped b = 8 only 8 of the 132 SMs work.

#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 8;  // lanes per column
constexpr int kPad = 8;    // row padding of X^T in shared memory
constexpr int kDefaultSmem = 48 * 1024;

__global__ void tri_inv_kernel(const float* __restrict__ L,
                               float* __restrict__ X, int P) {
  extern __shared__ float smem[];
  const int ldx = P + kPad;
  float* Ls = smem;           // [P][P]
  float* XT = smem + P * P;   // [P][ldx], XT[c][i] = X[i][c]
  const size_t base = static_cast<size_t>(blockIdx.x) * P * P;
  for (int t = threadIdx.x; t < P * P; t += blockDim.x) Ls[t] = L[base + t];
  for (int t = threadIdx.x; t < P * ldx; t += blockDim.x) XT[t] = 0.0f;
  __syncthreads();

  const int c = threadIdx.x / kSplit;
  const int q = threadIdx.x % kSplit;
  float* xc = XT + c * ldx;
  const int p0 = (c & ~(kSplit - 1)) + q;  // first term that can be non-zero
  for (int i = 0; i < P; ++i) {
    float s = 0.0f;
    if (i >= c) {
      const float* li = Ls + i * P;
      for (int p = p0; p < i; p += kSplit) s += li[p] * xc[p];
    }
    for (int o = kSplit / 2; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (q == 0 && i >= c) xc[i] = ((i == c ? 1.0f : 0.0f) - s) / Ls[i * P + i];
    __syncwarp();
  }
  __syncthreads();

  for (int t = threadIdx.x; t < P * P; t += blockDim.x) {
    const int i = t / P, k = t % P;
    X[base + t] = XT[k * ldx + i];
  }
}

}  // namespace

// L, X: [b, P, P] contiguous float32 on the device, 0 < P <= 128 and
// P % 4 == 0 (the block is P x 8 threads, whole warps).  Launches on
// `stream`, allocates nothing, and returns the first CUDA error.
extern "C" int tri_inv_base(const float* L, float* X, int b, int P,
                            void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(P) * P +
                       static_cast<size_t>(P) * (P + kPad));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        tri_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tri_inv_kernel<<<b, P * kSplit, smem, static_cast<cudaStream_t>(stream)>>>(
      L, X, P);
  return static_cast<int>(cudaGetLastError());
}
