// Patch extraction in transposed patch order (K6) and its adjoint (K7).
//
// K6 replaces the TPU kernel `_extract_kernel` (body `extract_into`) in
// deepcgp_tpu/ops/pallas_patches.py: images [N, H, W, C] -> patches
// [N, P, L] with P = Hout * Wout in TRANSPOSED patch order
// p = ox * Hout + oy (column-major over the output grid) and the elements
// of a patch in TF order (dy, dx, c), channels fastest.  K7 replaces
// `_col2im_kernel` (body `col2im_into`), the backward of the extraction:
// every patch element summed back into the pixel it was read from.
//
// What bounds them on an H100: bytes.  K6 reads the image and writes f*f/s^2
// times as many floats; K7 reads those and writes the image; neither does
// arithmetic of note (K7 one add per patch element).  The TPU kernels copy
// whole [b, Hout, f*C] windows through VMEM because its stores are
// (8, 128)-tiled; here each thread owns one output element, so the stores
// of a warp are 32 consecutive floats, and the loads, which reread each
// image pixel up to f*f times, mostly hit L1/L2.
//
// K7 is a gather, not a scatter: one thread per image element visits the
// (dy, dx) whose patch covers its pixel -- (y - dy*d) and (x - dx*d) that
// are >= 0, divisible by the stride and inside the output grid -- and sums
// their elements in float32 in a fixed order, then writes once.  So it needs
// no atomics, gives the same bits on every run, and writes zeros where no
// patch covers a pixel (stride > 1 or dilation > 1 can leave such pixels).
// Indices are 64-bit: N * P * L may pass 2^31.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Blocks of a grid-stride launch: 132 SMs x 16 resident blocks of 256.
constexpr int64_t kMaxBlocks = 132 * 16;

struct Geometry {
  int H, W, C, f, s, d, Hout, Wout;
};

__global__ void extract_transposed_kernel(const float* __restrict__ img,
                                          float* __restrict__ out,
                                          int64_t total, Geometry g) {
  const int fC = g.f * g.C;
  const int L = g.f * fC;
  const int P = g.Hout * g.Wout;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int l = static_cast<int>(i % L);
    const int64_t np = i / L;
    const int p = static_cast<int>(np % P);
    const int64_t n = np / P;
    const int ox = p / g.Hout, oy = p % g.Hout;
    const int dy = l / fC, r = l % fC;
    const int dx = r / g.C, c = r % g.C;
    const int y = oy * g.s + dy * g.d;
    const int x = ox * g.s + dx * g.d;
    out[i] = img[((n * g.H + y) * g.W + x) * g.C + c];
  }
}

__global__ void col2im_transposed_kernel(const float* __restrict__ grad,
                                         float* __restrict__ out,
                                         int64_t total, Geometry g) {
  const int fC = g.f * g.C;
  const int L = g.f * fC;
  const int P = g.Hout * g.Wout;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int c = static_cast<int>(i % g.C);
    int64_t t = i / g.C;
    const int x = static_cast<int>(t % g.W);
    t /= g.W;
    const int y = static_cast<int>(t % g.H);
    const int64_t n = t / g.H;
    const float* gn = grad + n * P * L;
    float acc = 0.0f;
    for (int dy = 0; dy < g.f; ++dy) {
      const int yy = y - dy * g.d;
      if (yy < 0) break;
      if (yy % g.s != 0) continue;
      const int oy = yy / g.s;
      if (oy >= g.Hout) continue;
      for (int dx = 0; dx < g.f; ++dx) {
        const int xx = x - dx * g.d;
        if (xx < 0) break;
        if (xx % g.s != 0) continue;
        const int ox = xx / g.s;
        if (ox >= g.Wout) continue;
        acc += gn[static_cast<int64_t>(ox * g.Hout + oy) * L + dy * fC +
                  dx * g.C + c];
      }
    }
    out[i] = acc;
  }
}

unsigned blocks_for(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// img [N, H, W, C] -> out [N, Hout*Wout, f*f*C], both contiguous float32 on
// the device.  Launches on `stream`, allocates nothing, and returns the
// first CUDA error.
extern "C" int extract_patches_transposed(const float* img, float* out, int N,
                                          int H, int W, int C, int f, int s,
                                          int d, int Hout, int Wout,
                                          void* stream) {
  const int64_t total =
      static_cast<int64_t>(N) * Hout * Wout * f * f * C;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const Geometry g{H, W, C, f, s, d, Hout, Wout};
  extract_transposed_kernel<<<blocks_for(total), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      img, out, total, g);
  return static_cast<int>(cudaGetLastError());
}

// grad [N, Hout*Wout, f*f*C] -> out [N, H, W, C], the adjoint of
// `extract_patches_transposed`; same conventions.
extern "C" int col2im_transposed(const float* grad, float* out, int N, int H,
                                 int W, int C, int f, int s, int d, int Hout,
                                 int Wout, void* stream) {
  const int64_t total = static_cast<int64_t>(N) * H * W * C;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const Geometry g{H, W, C, f, s, d, Hout, Wout};
  col2im_transposed_kernel<<<blocks_for(total), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      grad, out, total, g);
  return static_cast<int>(cudaGetLastError());
}
