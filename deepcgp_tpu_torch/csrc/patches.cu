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
// What bounds them on an H100: bytes.  K6 reads each image once and writes
// f*f/s^2 times as many floats; K7 reads those and writes the image; neither
// does arithmetic of note (K7 one add per patch element).  So both are
// streams: every float moves in a vector of V = 4, 2 or 1 floats (the
// largest that divides C and both pointers' alignment, so a vector never
// straddles a pixel and every access is V-aligned), and no index is taken
// apart by a division inside a loop.
//
// K6.  out[n] is one contiguous span of P * L floats, and a run of whole
// output columns ox, or of rows oy within one column, is one contiguous
// piece of it (a task).  A block stages the band of pixels its task reads
// (those rows and columns, every channel, at most 48 KB so that four
// blocks share an SM) in shared memory, then writes the piece front to
// back: each pass of the block stores 256 consecutive vectors, a warp 32
// of them, each read from the band at an offset that the thread carries
// from its last pass by a mixed-radix add of one constant step (ox, oy,
// dy, dx, c) -- 32-bit adds and compares only.  Tasks are sized from the
// device's SM count (at least four tasks an SM over the N images) and
// halved until their band fits; where not even one patch's band fits, the
// block reads the image from global memory the same way instead.
//
// K7 is a gather, not a scatter: one thread per image vector (V channels of
// a pixel) visits the (dy, dx) whose patch covers its pixel -- (y - dy*d)
// and (x - dx*d) that are >= 0, divisible by the stride and inside the
// output grid -- and sums their elements in float32 in ascending (dy, dx)
// order, then writes once.  So it needs no atomics, gives the same bits on
// every run, and writes zeros where no patch covers a pixel (stride > 1 or
// dilation > 1 can leave such pixels).  Each patch element is read exactly
// once, as part of a vector: with C = 32 a warp's load at one (dy, dx) is 8
// pixels' whole 128-byte channel runs.  The gather is bound by the loads a
// thread keeps in flight, and a load behind a branch leaves one: so every
// (dy, dx) loads, from a cached address where it misses the grid, and adds
// only where it hits, with both loops unrolled.
//
// Indices are 32-bit wherever every offset into the images and the patches
// fits (N * max(P * L, H * W * C) + 256 < 2^31, true at every path's
// shape); a 64-bit instance of each kernel takes the rest.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// A K6 block's band, at most: the default dynamic shared memory of a
// launch, so that four blocks of 256 threads share an SM.
constexpr int64_t kBandBytes = 48 * 1024;
// K6 cuts the images into at least this many tasks an SM.
constexpr int kTasksPerSm = 4;
constexpr int kMaxDevices = 64;

struct Geometry {
  int H, W, C, f, s, d, Hout, Wout;
};

// K6's split, fixed for a launch.  A task is kc output columns from ox0
// (then kr == Hout) or kr rows of one column from oy0 (then kc == 1); its
// band is bh x bw pixels from (oy0 * s, ox0 * s), 0 x 0 when not staged.
// One pass of a block moves each thread kThreads vectors on, which is
// step_ox columns, step_oy rows, step_dy, step_dx and step_c vectors in a
// mixed radix (-, Hout, f, f, C / vec).
struct ExtractPlan {
  int vec, kc, kr, tasks_y, tasks_per_image, bh, bw, staged;
  int step_ox, step_oy, step_dy, step_dx, step_c;
  int64_t tasks;
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Floats a vector: the largest of 4, 2, 1 that divides C and both
// pointers' alignment.
int vector_width(int C, const void* a, const void* b) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b);
  for (int v = 4; v > 1; v /= 2)
    if (C % v == 0 && align % (v * sizeof(float)) == 0) return v;
  return 1;
}

// True where every offset into the images and the patches, and K6's index
// one pass beyond its last, fits 32 bits.
bool fits_32(int N, const Geometry& g) {
  const int64_t pl = int64_t{g.Hout} * g.Wout * g.f * g.f * g.C;
  const int64_t hwc = int64_t{g.H} * g.W * g.C;
  return pl < INT_MAX && hwc < INT_MAX &&
         int64_t{N} * std::max(pl, hwc) <= INT_MAX - kThreads;
}

ExtractPlan extract_plan(int N, const Geometry& g, int vec, int sms) {
  ExtractPlan p{};
  p.vec = vec;
  const int64_t reach = int64_t{g.f - 1} * g.d + 1;  // pixels a patch spans
  auto band_bytes = [&](int64_t kc, int64_t kr) {
    return ((kr - 1) * g.s + reach) * ((kc - 1) * g.s + reach) * g.C *
           int64_t{sizeof(float)};
  };
  // Tasks an image for kTasksPerSm tasks an SM: whole columns while that
  // asks for no more than Wout tasks, else rows of one column.
  const int64_t want = ceil_div(int64_t{kTasksPerSm} * sms, N);
  int64_t kc = g.Wout, kr = g.Hout;
  if (want <= g.Wout) {
    kc = ceil_div(g.Wout, want);
  } else {
    kc = 1;
    kr = ceil_div(g.Hout, std::min<int64_t>(g.Hout, ceil_div(want, g.Wout)));
  }
  // Halve the columns, then the rows, until the band fits.
  int64_t sc = kc, sr = kr;
  while (band_bytes(sc, sr) > kBandBytes && (sc > 1 || sr > 1)) {
    if (sc > 1) sc = (sc + 1) / 2;
    else sr = (sr + 1) / 2;
  }
  p.staged = band_bytes(sc, sr) <= kBandBytes;
  if (p.staged) {
    kc = sc;
    kr = sr;
    p.bh = static_cast<int>((kr - 1) * g.s + reach);
    p.bw = static_cast<int>((kc - 1) * g.s + reach);
  }
  p.kc = static_cast<int>(kc);
  p.kr = static_cast<int>(kr);
  p.tasks_y = static_cast<int>(ceil_div(g.Hout, kr));
  p.tasks_per_image = static_cast<int>(ceil_div(g.Wout, kc)) * p.tasks_y;
  p.tasks = int64_t{N} * p.tasks_per_image;
  const int64_t Cv = g.C / vec, fCv = g.f * Cv, Lv = g.f * fCv;
  const int64_t dp = kThreads / Lv, dl = kThreads % Lv;
  p.step_ox = static_cast<int>(dp / g.Hout);
  p.step_oy = static_cast<int>(dp % g.Hout);
  p.step_dy = static_cast<int>(dl / fCv);
  p.step_dx = static_cast<int>(dl % fCv / Cv);
  p.step_c = static_cast<int>(dl % Cv);
  return p;
}

template <typename T, bool kStaged, typename I>
__global__ void __launch_bounds__(kThreads)
    extract_transposed_kernel(const float* __restrict__ img,
                              float* __restrict__ out, Geometry g,
                              ExtractPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* band = reinterpret_cast<T*>(smem);
  constexpr int V = sizeof(T) / sizeof(float);
  const int Cv = g.C / V;
  const I Lv = static_cast<I>(g.f) * g.f * Cv;
  const I image_v = static_cast<I>(g.H) * g.W * Cv;
  const I patches_v = static_cast<I>(g.Hout) * g.Wout * Lv;
  for (int64_t task = blockIdx.x; task < pl.tasks; task += gridDim.x) {
    const int64_t n = task / pl.tasks_per_image;
    const int r = static_cast<int>(task - n * pl.tasks_per_image);
    const int ox0 = r / pl.tasks_y * pl.kc, oy0 = r % pl.tasks_y * pl.kr;
    const int kc = min(pl.kc, g.Wout - ox0), kr = min(pl.kr, g.Hout - oy0);
    const I p0 = static_cast<I>(ox0) * g.Hout + oy0;
    const T* img_n = reinterpret_cast<const T*>(img) + n * image_v;
    T* dst = reinterpret_cast<T*>(out) + n * patches_v + p0 * Lv;
    const I count = static_cast<I>(kc) * kr * Lv;
    const T* src = img_n;
    int pitch = g.W, y0 = 0, x0 = 0;
    if constexpr (kStaged) {
      // The task's band: rows and columns of the image, every channel.
      y0 = oy0 * g.s;
      x0 = ox0 * g.s;
      const int rows = min(pl.bh, g.H - y0);
      const int row_v = min(pl.bw, g.W - x0) * Cv, pitch_v = pl.bw * Cv;
      __syncthreads();  // the last task's reads of the band are done
      for (int i = threadIdx.x; i < rows * row_v; i += kThreads) {
        const int y = i / row_v, j = i - y * row_v;
        band[y * pitch_v + j] =
            img_n[(static_cast<I>(y0 + y) * g.W + x0) * Cv + j];
      }
      __syncthreads();
      src = band;
      pitch = pl.bw;
    }
    // This thread's first vector, q = threadIdx.x, taken apart once.
    I q = threadIdx.x;
    const I p = p0 + q / Lv;
    int ox = static_cast<int>(p / g.Hout), oy = static_cast<int>(p % g.Hout);
    int l = static_cast<int>(q % Lv);
    int dy = l / (g.f * Cv);
    l -= dy * g.f * Cv;
    int dx = l / Cv, c = l - dx * Cv;
#pragma unroll 4
    for (; q < count; q += kThreads) {
      dst[q] = src[(static_cast<I>(oy * g.s + dy * g.d - y0) * pitch +
                    (ox * g.s + dx * g.d - x0)) * Cv + c];
      c += pl.step_c;
      dx += pl.step_dx;
      dy += pl.step_dy;
      oy += pl.step_oy;
      ox += pl.step_ox;
      if (c >= Cv) { c -= Cv; ++dx; }
      if (dx >= g.f) { dx -= g.f; ++dy; }
      if (dy >= g.f) { dy -= g.f; ++oy; }
      if (oy >= g.Hout) { oy -= g.Hout; ++ox; }
    }
  }
}

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float2& a, float2 b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    col2im_transposed_kernel(const float* __restrict__ grad,
                             float* __restrict__ out, I total, Geometry g) {
  constexpr int V = sizeof(T) / sizeof(float);
  const int Cv = g.C / V;
  const I Lv = static_cast<I>(g.f) * g.f * Cv;
  const I patches_v = static_cast<I>(g.Hout) * g.Wout * Lv;
  const T* gv = reinterpret_cast<const T*>(grad);
  T* ov = reinterpret_cast<T*>(out);
  for (int64_t k = int64_t{blockIdx.x} * kThreads + threadIdx.x; k < total;
       k += int64_t{gridDim.x} * kThreads) {
    const I i = static_cast<I>(k);
    I t = i / Cv;
    const int c = static_cast<int>(i - t * Cv);
    const int x = static_cast<int>(t % g.W);
    t /= g.W;
    const int y = static_cast<int>(t % g.H);
    const T* gn = gv + (t / g.H) * patches_v + c;
    // Every (dy, dx) loads, the ones that miss the grid from gn[0] (a
    // cached address) and add nothing: nothing between the loads branches,
    // so the unrolled loops keep many of them in flight.
    T acc{};
#pragma unroll 5
    for (int dy = 0; dy < g.f; ++dy) {
      const int yy = y - dy * g.d;
      const int oy = g.s > 1 ? yy / g.s : yy;
      const bool row_ok = yy >= 0 && oy * g.s == yy && oy < g.Hout;
#pragma unroll 5
      for (int dx = 0; dx < g.f; ++dx) {
        const int xx = x - dx * g.d;
        const int ox = g.s > 1 ? xx / g.s : xx;
        const bool ok = row_ok && xx >= 0 && ox * g.s == xx && ox < g.Wout;
        const T v = gn[ok ? (static_cast<I>(ox) * g.Hout + oy) * Lv +
                                (dy * g.f + dx) * Cv
                          : 0];
        if (ok) add(acc, v);
      }
    }
    ov[i] = acc;
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int cached[kMaxDevices] = {};
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *sms;
  return err;
}

unsigned grid_of(int64_t items) {
  return static_cast<unsigned>(std::min<int64_t>(items, INT_MAX));
}

template <typename T, bool kStaged, typename I>
cudaError_t launch_extract(const float* img, float* out, const Geometry& g,
                           const ExtractPlan& p, cudaStream_t stream) {
  const size_t smem =
      kStaged ? size_t{sizeof(float)} * p.bh * p.bw * g.C : 0;
  extract_transposed_kernel<T, kStaged, I>
      <<<grid_of(p.tasks), kThreads, smem, stream>>>(img, out, g, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t extract_launch(const float* img, float* out, int N,
                           const Geometry& g, const ExtractPlan& p,
                           cudaStream_t stream) {
  const bool narrow = fits_32(N, g);
  if (p.staged)
    return narrow ? launch_extract<T, true, int>(img, out, g, p, stream)
                  : launch_extract<T, true, int64_t>(img, out, g, p, stream);
  return narrow ? launch_extract<T, false, int>(img, out, g, p, stream)
                : launch_extract<T, false, int64_t>(img, out, g, p, stream);
}

template <typename T>
cudaError_t col2im_launch(const float* grad, float* out, int N,
                          const Geometry& g, cudaStream_t stream) {
  constexpr int V = sizeof(T) / sizeof(float);
  const int64_t total = int64_t{N} * g.H * g.W * (g.C / V);
  const unsigned grid = grid_of(ceil_div(total, kThreads));
  if (fits_32(N, g))
    col2im_transposed_kernel<T, int><<<grid, kThreads, 0, stream>>>(
        grad, out, static_cast<int>(total), g);
  else
    col2im_transposed_kernel<T, int64_t><<<grid, kThreads, 0, stream>>>(
        grad, out, total, g);
  return cudaGetLastError();
}

}  // namespace

// img [N, H, W, C] -> out [N, Hout*Wout, f*f*C], both contiguous float32 on
// the device.  Launches on `stream`, allocates nothing, and returns the
// first CUDA error.
extern "C" int extract_patches_transposed(const float* img, float* out, int N,
                                          int H, int W, int C, int f, int s,
                                          int d, int Hout, int Wout,
                                          void* stream) {
  if (N == 0) return static_cast<int>(cudaSuccess);
  const Geometry g{H, W, C, f, s, d, Hout, Wout};
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = vector_width(C, img, out);
  const ExtractPlan p = extract_plan(N, g, vec, sms);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t launched =
      vec == 4   ? extract_launch<float4>(img, out, N, g, p, st)
      : vec == 2 ? extract_launch<float2>(img, out, N, g, p, st)
                 : extract_launch<float>(img, out, N, g, p, st);
  return static_cast<int>(launched);
}

// K6's split for these arguments, as `extract_patches_transposed` would
// launch it, into plan[10]: SM count, vec, kc, kr, tasks_y,
// tasks_per_image, bh, bw, staged, tasks.  Launches nothing.
extern "C" int extract_patches_plan(const float* img, const float* out, int N,
                                    int H, int W, int C, int f, int s, int d,
                                    int Hout, int Wout, long long* plan) {
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{H, W, C, f, s, d, Hout, Wout};
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ExtractPlan p = extract_plan(N, g, vector_width(C, img, out), sms);
  const long long v[10] = {sms,  p.vec, p.kc, p.kr,     p.tasks_y,
                           p.tasks_per_image, p.bh, p.bw, p.staged, p.tasks};
  std::copy(v, v + 10, plan);
  return static_cast<int>(cudaSuccess);
}

// grad [N, Hout*Wout, f*f*C] -> out [N, H, W, C], the adjoint of
// `extract_patches_transposed`; same conventions.
extern "C" int col2im_transposed(const float* grad, float* out, int N, int H,
                                 int W, int C, int f, int s, int d, int Hout,
                                 int Wout, void* stream) {
  if (N == 0) return static_cast<int>(cudaSuccess);
  const Geometry g{H, W, C, f, s, d, Hout, Wout};
  const auto st = static_cast<cudaStream_t>(stream);
  const int vec = vector_width(C, grad, out);
  const cudaError_t launched =
      vec == 4   ? col2im_launch<float4>(grad, out, N, g, st)
      : vec == 2 ? col2im_launch<float2>(grad, out, N, g, st)
                 : col2im_launch<float>(grad, out, N, g, st);
  return static_cast<int>(launched);
}
