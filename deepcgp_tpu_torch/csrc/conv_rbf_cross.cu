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
// Replaces the TPU kernel `_fwd_kernel` in deepcgp_tpu/ops/pallas_cross.py.
// The patch weights come in the stored TF patch order: the transposed
// patch order and the selection matrices of the TPU kernel worked around
// its compiler and carry no meaning here.
//
// What bounds it on an H100: arithmetic.  At the flagship last layer
// (N = 640 images of 10x10x10, f = 5, P = 36 patches of L = 250, M = 384)
// the cross products are 2 N P M L = 4.4 GFLOP and the symmetric Kdiag
// grams N P (P+1) L = 0.2 GFLOP, against ~4 MB of images, Z and outputs.
// The gram's dot products run over columns q >= the warp's first row (a
// warp's lanes span 64 columns, so some of its lanes still compute terms
// below the diagonal) and its exp and weighting over q >= p only.  All of it
// is float32 FMA, outside the tensor cores, as the TPU kernel's full-f32
// default does.
// Design: one thread block per image, one warp per 8 patch rows (P = 36
// pads to 40 rows, 5 warps).  The image's patch matrix is built once in
// shared memory, transposed to [L][Ppad], and never reaches device memory.
// Each lane owns 4 adjacent inducing columns of a 128-column tile and keeps
// an 8 x 4 block of dot products in registers; per patch element it loads
// 8 row values as two broadcast float4 reads of shared memory and 4 Z
// values as one float4 read of the transposed, padded Zt [L][Mpad] (L1/L2
// resident: 384 KB, read by every block), so the loop has no barrier and
// 32 FMAs per 3 loads.  The exp, the clamp and the weighted patch sum run
// in the epilogue; the [P, M] kernel matrix never leaves registers.  The
// Kdiag gram runs the same scheme with lanes over patch columns.
// No tensor cores, cp.async or TMA yet.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;     // patch rows per warp
constexpr int kMT = 128;     // inducing columns per tile: 32 lanes x 4
constexpr int kMaxWarps = 8;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic smem without opt-in
constexpr int kMaxDevices = 64;

__host__ __device__ inline int padded_rows(int P) { return (P + 7) / 8 * 8; }
__host__ __device__ inline int block_warps(int P) {
  const int w = padded_rows(P) / kRows;
  return w < kMaxWarps ? w : kMaxWarps;
}

__global__ void conv_rbf_cross_kernel(
    const float* __restrict__ img, const float* __restrict__ Zt,
    const float* __restrict__ scal, const float* __restrict__ u,
    const float* __restrict__ wkd, float* __restrict__ kzx,
    float* __restrict__ kd, int H, int W, int C, int f, int stride,
    int dilation, int Hout, int Wout, int M, int Mpad, int with_kdiag) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = Hout * Wout;
  const int L = f * f * C;
  const int Ppad = padded_rows(P);
  const int nw = blockDim.x / 32;
  float* PsT = smem;                 // [L][Ppad]
  float* pn = PsT + L * Ppad;        // [Ppad]
  float* zn = pn + Ppad;             // [kMT]
  float* red = zn + kMT;             // [nw][kMT]

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int n = blockIdx.x;
  const float var = scal[0];
  const float gamma = scal[1];
  const float* x = img + static_cast<size_t>(n) * H * W * C;

  // im2col into shared memory; padded rows p >= P are zeros.
  for (int t = tid; t < Ppad * L; t += blockDim.x) {
    const int p = t / L, l = t % L;
    float v = 0.0f;
    if (p < P) {
      const int oy = p / Wout, ox = p % Wout;
      const int fy = l / (f * C), r = l % (f * C);
      const int fx = r / C, c = r % C;
      const int yy = oy * stride + fy * dilation;
      const int xx = ox * stride + fx * dilation;
      v = x[(yy * W + xx) * C + c];
    }
    PsT[l * Ppad + p] = v;
  }
  __syncthreads();
  for (int p = tid; p < Ppad; p += blockDim.x) {
    float s = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float v = PsT[l * Ppad + p];
      s += v * v;
    }
    pn[p] = s;
  }
  __syncthreads();

  if (with_kdiag) {
    // Gram of the image's patches: warp rows x lane columns (q = lane and
    // lane + 32 of each 64-column tile), from the warp's first row on.
    float local = 0.0f;
    for (int p0 = w * kRows; p0 < Ppad; p0 += nw * kRows) {
      for (int q0 = p0; q0 < Ppad; q0 += 64) {  // q >= p0 only
        const int qa = q0 + lane, qb = q0 + lane + 32;
        const bool has_b = qb < Ppad;
        float g[kRows][2];
#pragma unroll
        for (int r = 0; r < kRows; ++r) g[r][0] = g[r][1] = 0.0f;
        for (int l = 0; l < L; ++l) {
          const float* row = PsT + l * Ppad;
          const float4 a0 = *reinterpret_cast<const float4*>(row + p0);
          const float4 a1 = *reinterpret_cast<const float4*>(row + p0 + 4);
          const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float ba = qa < Ppad ? row[qa] : 0.0f;
          const float bb = has_b ? row[qb] : 0.0f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            g[r][0] += a[r] * ba;
            g[r][1] += a[r] * bb;
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int p = p0 + r;
          if (p >= P) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // Kd is symmetric (g[p][q] and g[q][p] are the same sum, term
            // for term): the upper triangle, its off-diagonal terms twice.
            const int q = h ? qb : qa;
            if (q >= P || q < p) continue;
            const float e = pn[p] + pn[q] - 2.0f * g[r][h];
            const float twice = q > p ? 2.0f : 1.0f;
            local += twice * wkd[p] * wkd[q] *
                     (var * expf(gamma * fmaxf(e, 0.0f)));
          }
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) local += __shfl_down_sync(0xffffffffu, local, o);
    if (lane == 0) red[w] = local;
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int i = 0; i < nw; ++i) s += red[i];
      kd[n] = s / (static_cast<float>(P) * static_cast<float>(P));
    }
    __syncthreads();  // red is reused below
  } else if (tid == 0) {
    kd[n] = 0.0f;
  }

  for (int m0 = 0; m0 < M; m0 += kMT) {
    const float* zcol = Zt + m0 + 4 * lane;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p0 = 0; p0 < Ppad; p0 += nw * kRows) {
      const int pw = p0 + w * kRows;
      const bool active = pw < Ppad;  // warp-uniform
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
      float zsq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (active) {
#pragma unroll 4
        for (int l = 0; l < L; ++l) {
          const float4 z = __ldg(reinterpret_cast<const float4*>(
              zcol + static_cast<size_t>(l) * Mpad));
          const float* row = PsT + l * Ppad + pw;
          const float4 a0 = *reinterpret_cast<const float4*>(row);
          const float4 a1 = *reinterpret_cast<const float4*>(row + 4);
          const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float zz[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] += a[r] * zz[j];
          if (p0 == 0 && w == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) zsq[j] += zz[j] * zz[j];
          }
        }
      }
      if (p0 == 0) {
        if (w == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) zn[4 * lane + j] = zsq[j];
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int p = pw + r;
          if (p >= P) continue;
          const float up = u[p];
          const float pnp = pn[p];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d2 = pnp + zn[4 * lane + j] - 2.0f * acc[r][j];
            part[j] += up * (var * expf(gamma * fmaxf(d2, 0.0f)));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[w * kMT + 4 * lane + j] = part[j];
    __syncthreads();
    for (int t = tid; t < kMT; t += blockDim.x) {
      if (m0 + t < M) {
        float s = 0.0f;
        for (int i = 0; i < nw; ++i) s += red[i * kMT + t];
        kzx[static_cast<size_t>(n) * M + m0 + t] = s;
      }
    }
    __syncthreads();  // zn and red are rewritten by the next tile
  }
}

}  // namespace

// Dynamic shared memory one block needs for a geometry; the caller refuses
// geometries above the card's per-block limit.
extern "C" size_t conv_rbf_cross_smem_bytes(int P, int L) {
  const int Ppad = padded_rows(P);
  const size_t floats = static_cast<size_t>(L) * Ppad + Ppad + kMT +
                        static_cast<size_t>(block_warps(P)) * kMT;
  return floats * sizeof(float);
}

// img [N, H, W, C]; Zt [f*f*C, Mpad] = Z^T zero-padded to a multiple of
// 128 columns; scal [2] = (variance, gamma); u [P] and wkd [P] in TF patch
// order: contiguous float32 on the device.  Writes kzx [N, M] and kd [N]
// (zeros unless with_kdiag).  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
extern "C" int conv_rbf_cross(const float* img, const float* Zt,
                              const float* scal, const float* u,
                              const float* wkd, float* kzx, float* kd, int N,
                              int H, int W, int C, int f, int stride,
                              int dilation, int M, int Mpad, int with_kdiag,
                              void* stream) {
  const int eff = (f - 1) * dilation + 1;
  const int Hout = (H - eff) / stride + 1;
  const int Wout = (W - eff) / stride + 1;
  const int P = Hout * Wout;
  const size_t smem = conv_rbf_cross_smem_bytes(P, f * f * C);
  if (smem > kDefaultSmem) {
    // Opt in to more dynamic shared memory than a launch gets by default,
    // once per device and size: the attribute keeps the largest size set.
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    static size_t opted[kMaxDevices] = {};
    if (dev >= kMaxDevices || smem > opted[dev]) {
      err = cudaFuncSetAttribute(conv_rbf_cross_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < kMaxDevices) opted[dev] = smem;
    }
  }
  conv_rbf_cross_kernel<<<N, 32 * block_warps(P), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      img, Zt, scal, u, wkd, kzx, kd, H, W, C, f, stride, dilation, Hout,
      Wout, M, Mpad, with_kdiag);
  return static_cast<int>(cudaGetLastError());
}
