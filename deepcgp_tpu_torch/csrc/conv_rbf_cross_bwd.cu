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
// What bounds it on an H100: arithmetic.  At the flagship training step
// (N = 320 images of 10x10x10, f = 5, P = 36, L = 250, M = 384) the
// recomputed cross products, T Z and T^T patches are 3 x 2 N P M L =
// 6.6 GFLOP, the gram and its product 0.3 GFLOP, against ~4 MB of inputs
// and outputs.  All float32 FMA, outside the tensor cores.
//
// Design: two launches.  dZ sums over every image, and one [M, L] partial
// per image would be 123 MB at the flagship, so the work splits:
//  1. image side, one block per image (one warp per 8 patch rows, P <= 64):
//     builds the patch matrix in shared memory in two layouts, recomputes
//     the cross-covariance tile by tile with K4's 8 x 4 register tile,
//     writes T [N, P, Mpad] to device memory (17.7 MB at the flagship),
//     accumulates dpatches = T Z in registers (8 rows x 4 NLT columns a
//     lane, Z read as float4 from a padded [Mpad][Lpad] copy in L2), adds
//     the Kdiag gram terms, col2im's dpatches out of shared memory (a
//     gather over the patches that cover each pixel: no atomics), and
//     writes per-image partials of du, dwkd, dvar and dgamma, which the
//     wrapper sums;
//  2. Z side, blocks over (64 inducing rows, 128 patch elements, a chunk
//     of images): dZ = sum T^T (2 Z - 2 patches) with the same register
//     tile over T and patches staged per image in shared memory, and one
//     float atomicAdd per output element per block (a few million in all).
// No tensor cores, cp.async or TMA yet.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;       // patch rows per warp
constexpr int kMT = 128;       // inducing columns / patch elements per tile
constexpr int kMaxWarps = 8;   // so P <= 64
constexpr int kZRows = 64;     // inducing rows per Z-side block (8 x 8)
constexpr int kZThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__host__ __device__ inline int padded_rows(int P) { return (P + 7) / 8 * 8; }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline int patch_offset(int l, int f, int C, int W, int dilation) {
  const int fy = l / (f * C), r = l % (f * C);
  const int fx = r / C, c = r % C;
  return ((fy * dilation) * W + fx * dilation) * C + c;
}

template <int NLT>
__global__ void __launch_bounds__(kMaxWarps * 32) bwd_image_kernel(
    const float* __restrict__ img, const float* __restrict__ Zt,
    const float* __restrict__ Zp, const float* __restrict__ scal,
    const float* __restrict__ u, const float* __restrict__ wkd,
    const float* __restrict__ dkzx, const float* __restrict__ dkd,
    float* __restrict__ Tg, float* __restrict__ part,
    float* __restrict__ dimg, int H, int W, int C, int f, int stride,
    int dilation, int Hout, int Wout, int M, int Mpad, int with_kdiag) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = Hout * Wout;
  const int L = f * f * C;
  const int Ppad = padded_rows(P);
  constexpr int Lpad = NLT * kMT;
  float* PsT = smem;                    // [L][Ppad]: patches, transposed
  float* Xs = PsT + L * Ppad;           // [Ppad][Lpad]: patches; then dpatches
  float* TT = Xs + Ppad * Lpad;         // [kMT][Ppad]: T of one column tile
  float* SS = TT + kMT * Ppad;          // [Ppad][Ppad + 1]: S of the gram
  float* pn = SS + Ppad * (Ppad + 1);   // [Ppad]
  float* rs = pn + Ppad;                // [Ppad]: row sums of S + S^T
  float* dws = rs + Ppad;               // [Ppad]: sum_q w_q Kd[p, q]
  float* zn = dws + Ppad;               // [kMT]
  float* red = zn + kMT;                // [2 kMaxWarps]

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int n = blockIdx.x;
  const float var = scal[0];
  const float gamma = scal[1];
  const int HWC = H * W * C;
  const float* x = img + static_cast<size_t>(n) * HWC;

  // im2col into both layouts; padded rows and columns are zeros.
  for (int t = tid; t < Ppad * Lpad; t += blockDim.x) {
    const int p = t / Lpad, l = t % Lpad;
    float v = 0.0f;
    if (p < P && l < L) {
      const int oy = p / Wout, ox = p % Wout;
      v = x[((oy * stride) * W + ox * stride) * C +
            patch_offset(l, f, C, W, dilation)];
    }
    Xs[t] = v;
    if (l < L) PsT[l * Ppad + p] = v;
  }
  for (int p = tid; p < Ppad; p += blockDim.x) {
    rs[p] = 0.0f;
    dws[p] = 0.0f;
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

  float dvar_acc = 0.0f, dgam_acc = 0.0f;
  const float inv_p2 = 1.0f / (static_cast<float>(P) * static_cast<float>(P));
  const float dd = with_kdiag ? dkd[n] : 0.0f;
  if (with_kdiag) {
    // The image's own gram, one (p, q) pair per thread.  Kd[p,q] and
    // Kd[q,p] are the same sums term for term, so dwkd needs one of them.
    const int Sp = Ppad + 1;
    for (int t = tid; t < P * P; t += blockDim.x) {
      const int p = t / P, q = t % P;
      float g = 0.0f;
      for (int l = 0; l < L; ++l) g += PsT[l * Ppad + p] * PsT[l * Ppad + q];
      const float e = pn[p] + pn[q] - 2.0f * g;
      const float eh = fmaxf(e, 0.0f);
      const float kd = var * expf(gamma * eh);
      const float base = dd * wkd[p] * wkd[q] * inv_p2 * kd;
      dvar_acc += base;
      dgam_acc += base * eh;
      SS[p * Sp + q] = e > 0.0f ? base * gamma : 0.0f;
      atomicAdd(&dws[p], wkd[q] * kd);
    }
    __syncthreads();
    for (int p = tid; p < P; p += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < P; ++q) s += SS[p * Sp + q] + SS[q * Sp + p];
      rs[p] = s;
    }
    __syncthreads();
  }

  const int pw = w * kRows;          // this warp's first patch row
  float up[kRows], du_r[kRows], rowT[kRows];
  float dx[kRows][4 * NLT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    up[r] = pw + r < P ? u[pw + r] : 0.0f;
    du_r[r] = rowT[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NLT; ++c) dx[r][c] = 0.0f;
  }

  for (int m0 = 0; m0 < M; m0 += kMT) {
    // Cross products of the warp's 8 rows with the lane's 4 columns.
    const float* zcol = Zt + m0 + 4 * lane;
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
    float zsq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
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
      if (w == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) zsq[j] += zz[j] * zz[j];
      }
    }
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) zn[4 * lane + j] = zsq[j];
    }
    __syncthreads();

    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + 4 * lane + j;
      a[j] = m < M ? dkzx[static_cast<size_t>(n) * M + m] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = pw + r;
      float tv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d2 = pn[p] + zn[4 * lane + j] - 2.0f * acc[r][j];
        const float dh = fmaxf(d2, 0.0f);
        const float ak = a[j] * (var * expf(gamma * dh));
        const float auk = up[r] * ak;
        dvar_acc += auk;
        dgam_acc += auk * dh;
        const float t = d2 > 0.0f ? auk * gamma : 0.0f;
        du_r[r] += ak;
        rowT[r] += t;
        tv[j] = t;
        TT[(4 * lane + j) * Ppad + p] = t;
      }
      if (p < P) {
        *reinterpret_cast<float4*>(
            Tg + (static_cast<size_t>(n) * P + p) * Mpad + m0 + 4 * lane) =
            make_float4(tv[0], tv[1], tv[2], tv[3]);
      }
    }
    __syncthreads();

    // dpatches += T Z over this tile's columns.
    const int mlim = min(kMT, M - m0);
    for (int mm = 0; mm < mlim; ++mm) {
      const float4 t0 = *reinterpret_cast<const float4*>(TT + mm * Ppad + pw);
      const float4 t1 = *reinterpret_cast<const float4*>(TT + mm * Ppad + pw + 4);
      const float tr[kRows] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      const float* zrow = Zp + static_cast<size_t>(m0 + mm) * Lpad + 4 * lane;
#pragma unroll
      for (int lt = 0; lt < NLT; ++lt) {
        const float4 z = __ldg(reinterpret_cast<const float4*>(zrow + lt * kMT));
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dx[r][4 * lt + 0] += tr[r] * z.x;
          dx[r][4 * lt + 1] += tr[r] * z.y;
          dx[r][4 * lt + 2] += tr[r] * z.z;
          dx[r][4 * lt + 3] += tr[r] * z.w;
        }
      }
    }
    __syncthreads();  // TT and zn are rewritten by the next tile
  }

  const size_t pbase = static_cast<size_t>(n) * (2 * P + 2);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    du_r[r] = warp_sum(du_r[r]);
    rowT[r] = warp_sum(rowT[r]);
    if (lane == 0 && pw + r < P) part[pbase + pw + r] = du_r[r];
  }

  // dpatches in registers: the T terms, then the gram terms.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int p = pw + r;
#pragma unroll
    for (int lt = 0; lt < NLT; ++lt) {
      const float4 xp = *reinterpret_cast<const float4*>(
          Xs + p * Lpad + lt * kMT + 4 * lane);
      const float s = 2.0f * (rowT[r] + rs[p]);
      dx[r][4 * lt + 0] = -2.0f * dx[r][4 * lt + 0] + s * xp.x;
      dx[r][4 * lt + 1] = -2.0f * dx[r][4 * lt + 1] + s * xp.y;
      dx[r][4 * lt + 2] = -2.0f * dx[r][4 * lt + 2] + s * xp.z;
      dx[r][4 * lt + 3] = -2.0f * dx[r][4 * lt + 3] + s * xp.w;
    }
  }
  if (with_kdiag) {
    const int Sp = Ppad + 1;
    for (int q = 0; q < P; ++q) {
      float sq[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int p = pw + r;
        sq[r] = p < P ? 2.0f * (SS[p * Sp + q] + SS[q * Sp + p]) : 0.0f;
      }
#pragma unroll
      for (int lt = 0; lt < NLT; ++lt) {
        const float4 xq = *reinterpret_cast<const float4*>(
            Xs + q * Lpad + lt * kMT + 4 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dx[r][4 * lt + 0] -= sq[r] * xq.x;
          dx[r][4 * lt + 1] -= sq[r] * xq.y;
          dx[r][4 * lt + 2] -= sq[r] * xq.z;
          dx[r][4 * lt + 3] -= sq[r] * xq.w;
        }
      }
    }
  }
  __syncthreads();  // every read of the patches in Xs is done
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int lt = 0; lt < NLT; ++lt)
      *reinterpret_cast<float4*>(Xs + (pw + r) * Lpad + lt * kMT + 4 * lane) =
          make_float4(dx[r][4 * lt], dx[r][4 * lt + 1], dx[r][4 * lt + 2],
                      dx[r][4 * lt + 3]);
  __syncthreads();

  // col2im: each pixel gathers the patch elements that read it.
  float* di = dimg + static_cast<size_t>(n) * HWC;
  for (int t = tid; t < HWC; t += blockDim.x) {
    const int c = t % C, xx = (t / C) % W, yy = t / (W * C);
    float s = 0.0f;
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
    di[t] = s;
  }

  dvar_acc = warp_sum(dvar_acc);
  dgam_acc = warp_sum(dgam_acc);
  if (lane == 0) {
    red[w] = dvar_acc;
    red[kMaxWarps + w] = dgam_acc;
  }
  __syncthreads();
  const int nw = blockDim.x / 32;
  if (tid == 0) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < nw; ++i) {
      s1 += red[i];
      s2 += red[kMaxWarps + i];
    }
    part[pbase + 2 * P] = s1 / var;
    part[pbase + 2 * P + 1] = s2;
  }
  for (int p = tid; p < P; p += blockDim.x)
    part[pbase + P + p] = 2.0f * dd * inv_p2 * dws[p];
}

__global__ void __launch_bounds__(kZThreads) bwd_z_kernel(
    const float* __restrict__ img, const float* __restrict__ Z,
    const float* __restrict__ Tg, float* __restrict__ dZ, int N, int H,
    int W, int C, int f, int stride, int dilation, int Hout, int Wout, int M,
    int Mpad, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int P = Hout * Wout;
  const int L = f * f * C;
  const int Ppad = padded_rows(P);
  float* Ts = smem;                                   // [Ppad][kZRows]
  float* Xc = Ts + Ppad * kZRows;                     // [Ppad][kMT]
  int* loff = reinterpret_cast<int*>(Xc + Ppad * kMT);  // [kMT]
  int* poff = loff + kMT;                             // [Ppad]

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kZRows, l0 = blockIdx.y * kMT;
  const int n0 = blockIdx.z * chunk, n1 = min(N, n0 + chunk);
  for (int t = tid; t < kMT; t += blockDim.x) {
    const int l = l0 + t;
    loff[t] = l < L ? patch_offset(l, f, C, W, dilation) : -1;
  }
  for (int p = tid; p < P; p += blockDim.x) {
    const int oy = p / Wout, ox = p % Wout;
    poff[p] = ((oy * stride) * W + ox * stride) * C;
  }

  float acc[kRows][4], tsum[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    tsum[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  }
  const int HWC = H * W * C;
  for (int n = n0; n < n1; ++n) {
    __syncthreads();  // the tables are written; the previous image is used
    for (int t = tid; t < P * kZRows; t += blockDim.x) {
      const int p = t / kZRows, mm = t % kZRows;
      Ts[t] = Tg[(static_cast<size_t>(n) * P + p) * Mpad + m0 + mm];
    }
    const float* x = img + static_cast<size_t>(n) * HWC;
    for (int t = tid; t < P * kMT; t += blockDim.x) {
      const int p = t / kMT, lo = loff[t % kMT];
      Xc[t] = lo >= 0 ? x[poff[p] + lo] : 0.0f;
    }
    __syncthreads();
    for (int p = 0; p < P; ++p) {
      const float4 t0 = *reinterpret_cast<const float4*>(Ts + p * kZRows + 8 * w);
      const float4 t1 = *reinterpret_cast<const float4*>(Ts + p * kZRows + 8 * w + 4);
      const float4 xv = *reinterpret_cast<const float4*>(Xc + p * kMT + 4 * lane);
      const float tr[kRows] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        tsum[r] += tr[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] += tr[r] * xs[j];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + 8 * w + r;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + 4 * lane + j;
      if (l >= L) continue;
      const size_t i = static_cast<size_t>(m) * L + l;
      atomicAdd(dZ + i, 2.0f * (Z[i] * tsum[r] - acc[r][j]));
    }
  }
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

template <int NLT>
int launch_image(const float* img, const float* Zt, const float* Zp,
                 const float* scal, const float* u, const float* wkd,
                 const float* dkzx, const float* dkd, float* Tg, float* part,
                 float* dimg, int N, int H, int W, int C, int f, int stride,
                 int dilation, int Hout, int Wout, int M, int Mpad,
                 int with_kdiag, size_t smem, cudaStream_t stream) {
  static size_t opted[kMaxDevices] = {};
  cudaError_t err = opt_in(bwd_image_kernel<NLT>, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = padded_rows(Hout * Wout) / kRows;
  bwd_image_kernel<NLT><<<N, 32 * warps, smem, stream>>>(
      img, Zt, Zp, scal, u, wkd, dkzx, dkd, Tg, part, dimg, H, W, C, f,
      stride, dilation, Hout, Wout, M, Mpad, with_kdiag);
  return static_cast<int>(cudaGetLastError());
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
  const size_t floats = L * Ppad + Ppad * Lpad + kMT * Ppad +
                        Ppad * (Ppad + 1) + 3 * Ppad + kMT + 2 * kMaxWarps;
  return floats * sizeof(float);
}

extern "C" size_t conv_rbf_cross_bwd_z_smem_bytes(int P) {
  const size_t Ppad = padded_rows(P);
  return (Ppad * kZRows + Ppad * kMT) * sizeof(float) +
         (kMT + Ppad) * sizeof(int);
}

// Image side.  img [N, H, W, C]; Zt [L, Mpad] = Z^T and Zp [Mpad, Lpad] = Z,
// both zero-padded (Mpad a multiple of 128, Lpad = 128 ceil(L / 128));
// scal [2] = (variance, gamma); u, wkd [P] in TF patch order; dkzx [N, M];
// dkd [N] (read only when with_kdiag).  Writes T into Tg [N, P, Mpad],
// the per-image partials part [N, 2P + 2] = (du [P], dwkd [P], dvar,
// dgamma) and dimg [N, H, W, C].  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int conv_rbf_cross_bwd_image(
    const float* img, const float* Zt, const float* Zp, const float* scal,
    const float* u, const float* wkd, const float* dkzx, const float* dkd,
    float* Tg, float* part, float* dimg, int N, int H, int W, int C, int f,
    int stride, int dilation, int M, int Mpad, int with_kdiag, void* stream) {
  int Hout, Wout;
  out_dims(H, W, f, stride, dilation, &Hout, &Wout);
  const int L = f * f * C;
  const size_t smem = conv_rbf_cross_bwd_image_smem_bytes(Hout * Wout, L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((L + kMT - 1) / kMT) {
    case 1: return launch_image<1>(img, Zt, Zp, scal, u, wkd, dkzx, dkd, Tg,
                                   part, dimg, N, H, W, C, f, stride, dilation,
                                   Hout, Wout, M, Mpad, with_kdiag, smem, s);
    case 2: return launch_image<2>(img, Zt, Zp, scal, u, wkd, dkzx, dkd, Tg,
                                   part, dimg, N, H, W, C, f, stride, dilation,
                                   Hout, Wout, M, Mpad, with_kdiag, smem, s);
    case 3: return launch_image<3>(img, Zt, Zp, scal, u, wkd, dkzx, dkd, Tg,
                                   part, dimg, N, H, W, C, f, stride, dilation,
                                   Hout, Wout, M, Mpad, with_kdiag, smem, s);
    case 4: return launch_image<4>(img, Zt, Zp, scal, u, wkd, dkzx, dkd, Tg,
                                   part, dimg, N, H, W, C, f, stride, dilation,
                                   Hout, Wout, M, Mpad, with_kdiag, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Z side.  img [N, H, W, C]; Z [M, L]; Tg from the image side.  Zeroes and
// writes dZ [M, L], one block per (64 rows of Z, 128 patch elements,
// `chunk` images).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int conv_rbf_cross_bwd_z(const float* img, const float* Z,
                                    const float* Tg, float* dZ, int N, int H,
                                    int W, int C, int f, int stride,
                                    int dilation, int M, int Mpad, int chunk,
                                    void* stream) {
  int Hout, Wout;
  out_dims(H, W, f, stride, dilation, &Hout, &Wout);
  const int L = f * f * C;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dZ, 0, sizeof(float) * M * L, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = conv_rbf_cross_bwd_z_smem_bytes(Hout * Wout);
  static size_t opted[kMaxDevices] = {};
  err = opt_in(bwd_z_kernel, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Mpad / kZRows, (L + kMT - 1) / kMT, (N + chunk - 1) / chunk);
  bwd_z_kernel<<<grid, kZThreads, smem, s>>>(img, Z, Tg, dZ, N, H, W, C, f,
                                             stride, dilation, Hout, Wout, M,
                                             Mpad, chunk);
  return static_cast<int>(cudaGetLastError());
}
