// The Adam step of every float32 leaf of a model and its guarded commit,
// in two launches over one table of leaves:
//
//   adam_all_finite  one flag: every gradient element of every leaf is
//                    finite (the commit guard's gradient half);
//   adam_update      for each element of each leaf, in registers, the
//                    moments m' = b1 m + (1 - b1) g, v' = b2 v + (1 - b2) g^2,
//                    the update u = (m' / c1) / (sqrt(v' / c2) + eps) and
//                    p' = p - lr u; for a leaf with bf16 moments m' and v'
//                    are stored by stochastic rounding.  p', m' and v' are
//                    written only where the device flag `ok` is set, else
//                    p, m and v stay as they were.
//
// Replaces no Pallas kernel: the JAX package runs optax's `scale_by_adam`
// with its `_sr_to_bf16` moment store (deepcgp_tpu/training/optim.py) as
// jitted jnp code that XLA fuses.  Its eager form in the port,
// training/optim.py `adam_updates` followed by the trainer's torch.where
// commit, is this kernel's plain version and launches some 25 elementwise
// kernels a leaf, the bf16 store some 30 more passes of 8-byte integers.
// The kernel is bit for bit that code: every float operation runs in the
// same order with one rounding each (`__fmul_rn` and friends, so nothing
// is contracted into an FMA), the bias corrections c1, c2, the learning
// rate and the step's salt are the tensors torch computed once a step,
// read from device memory, and the dither hash is the same murmur-style
// hash of (flat index within the leaf, salt), here in uint32 registers
// with logical shifts and wrapping products.
//
// Bound: bytes.  The update reads p and g (4 B each) and m and v, and
// writes p, m and v: 20 B an element with bf16 moments, 28 B with float32
// ones; the finiteness pass reads g again, 4 B.  A few integer operations
// and one square root an element are far below the card's rate.  Design:
// the leaves (pointers, sizes, moment type, salt index) travel by value in
// the kernel's parameter space (`__grid_constant__`: read where they lie,
// never copied to local memory), so a captured graph keeps them in its
// node and no host copy is needed; each leaf is cut into chunks of kChunk
// elements, no chunk crossing a leaf, and the blocks, as many as fit on
// the SMs at once, walk the chunks of every leaf with a grid-stride loop.
// Each thread moves 16-byte vectors: four floats of p and g, four moments
// (16 B in float32, 8 B in bf16), so the loads of a warp are whole
// 512-byte lines and every byte is read once and written once.  No shared
// memory.  A leaf whose pointers are not 16-byte aligned takes the same
// arithmetic one element at a time.  A parameter need not be row-major (a
// fresh q_sqrt is the Cholesky factor's column-major layout): the kernels
// walk memory, and a bf16 leaf's dither index, the element's row-major
// flat index, comes from its offset through the leaf's map of dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 40;   // leaves of one launch's table
constexpr int kChunk = 2048;     // elements of a chunk: 8 a thread
constexpr int kThreads = 256;

// Leaf flags.
constexpr int kBf16 = 1;     // bf16 moments, stored by stochastic rounding
constexpr int kVector = 2;   // 16-byte loads: pointers aligned (and, if
                             // mapped, map_size[0] % 4 == 0)
constexpr int kMapped = 4;   // not row-major: the dither index through the map
constexpr int kMapDims = 4;

// The dither hash of the JAX package's `_sr_to_bf16`.
constexpr uint32_t kIndexMul = 2654435761u;
constexpr uint32_t kMix1 = 0x2C1B3C6Du;
constexpr uint32_t kMix2 = 0x297A2D39u;
constexpr uint32_t kSaltStep = 0x85EBCA77u;

struct AdamLeaf {
  float* p;
  const float* g;
  void* m;
  void* v;
  long long n;
  int flags;
  unsigned salt_index;   // the leaf's number among the bf16 leaves
  // A leaf whose memory order is not its row-major order (p, g, m and v
  // share one dense layout, and the kernels walk memory): its dims in
  // memory order, innermost first, and each one's row-major stride, so
  // that the element at memory offset o has the flat index the dither
  // hashes, sum_k (o / prod_{j<k} size_j % size_k) stride_k (mod 2^32).
  unsigned map_size[kMapDims];
  unsigned map_stride[kMapDims];
};

struct AdamTable {
  AdamLeaf leaf[kMaxLeaves];
  int chunk_end[kMaxLeaves];   // chunks of leaves 0..l together
  int leaves;
  int chunks;
  // The float32 values of b1, 1 - b1, b2, 1 - b2 and eps as torch casts
  // the Python scalars.
  float b1, omb1, b2, omb2, eps;
};

struct Step {
  float b1, omb1, b2, omb2, eps, c1, c2, lr;
};

__device__ __forceinline__ uint32_t dither(uint32_t index, uint32_t salt) {
  uint32_t h = index * kIndexMul + salt;
  h ^= h >> 15;
  h *= kMix1;
  h ^= h >> 12;
  h *= kMix2;
  h ^= h >> 15;
  return h & 0xFFFFu;
}

// float32 -> bf16 bits by stochastic rounding: the dither added to the bit
// pattern, the low 16 bits cut, then torch's float -> bf16 conversion on
// the card (cvt.rn, exact here but for NaN, which it makes canonical).
__device__ __forceinline__ uint32_t sr_bf16(float x, uint32_t index,
                                            uint32_t salt) {
  const uint32_t u = (__float_as_uint(x) + dither(index, salt)) & 0xFFFF0000u;
  return __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(u)));
}

// The flat (row-major) index of the element at memory offset o.
__device__ __forceinline__ uint32_t flat_index(const AdamLeaf& leaf,
                                               long long o) {
  uint32_t rest = static_cast<uint32_t>(o);
  if (!(leaf.flags & kMapped)) return rest;
  uint32_t index = 0;
#pragma unroll
  for (int k = 0; k < kMapDims; ++k) {
    index += rest % leaf.map_size[k] * leaf.map_stride[k];
    rest /= leaf.map_size[k];
  }
  return index;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// One element, in the plain version's order: each torch operation is one
// rounding.
__device__ __forceinline__ void adam_element(float& p, float g, float& m,
                                             float& v, const Step& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float u = __fdiv_rn(__fdiv_rn(m, s.c1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.eps));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

__device__ __forceinline__ bool not_finite(float x) {
  return (__float_as_uint(x) & 0x7F800000u) == 0x7F800000u;
}

// The chunk's leaf (l advances: a block's chunks only grow) and its
// elements [first, end).
__device__ __forceinline__ void chunk_span(const AdamTable& t, int c, int& l,
                                           long long& first,
                                           long long& end) {
  while (c >= t.chunk_end[l]) ++l;
  first = static_cast<long long>(c - (l ? t.chunk_end[l - 1] : 0)) * kChunk;
  end = min(first + kChunk, t.leaf[l].n);
}

__global__ void __launch_bounds__(kThreads)
    adam_finite_kernel(const __grid_constant__ AdamTable t, bool* all_finite) {
  bool bad = false;
  int l = 0;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    long long first, end;
    chunk_span(t, c, l, first, end);
    const float* g = t.leaf[l].g;
    long long i = first;
    if (t.leaf[l].flags & kVector) {
      const long long vend = first + ((end - first) & ~3LL);
      for (long long j = first + 4 * threadIdx.x; j < vend; j += 4 * kThreads) {
        const float4 x = *reinterpret_cast<const float4*>(g + j);
        bad |= not_finite(x.x) | not_finite(x.y) | not_finite(x.z) |
               not_finite(x.w);
      }
      i = vend;
    }
    for (i += threadIdx.x; i < end; i += kThreads) bad |= not_finite(g[i]);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *all_finite = false;
}

__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const __grid_constant__ AdamTable t, const float* c1,
                       const float* c2,
                       const float* lr, const long long* salt0,
                       const bool* ok) {
  if (!*ok) return;
  const Step s{t.b1, t.omb1, t.b2, t.omb2, t.eps, *c1, *c2, *lr};
  const uint32_t salt_step = static_cast<uint32_t>(*salt0);
  int l = 0;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    long long first, end;
    chunk_span(t, c, l, first, end);
    float* p = t.leaf[l].p;
    const float* g = t.leaf[l].g;
    const int flags = t.leaf[l].flags;
    const uint32_t salt_m = salt_step + 2u * t.leaf[l].salt_index * kSaltStep;
    const uint32_t salt_v = salt_m + kSaltStep;
    long long i = first;
    if (flags & kVector) {
      const long long vend = first + ((end - first) & ~3LL);
      for (long long j = first + 4 * threadIdx.x; j < vend; j += 4 * kThreads) {
        float4 pv = *reinterpret_cast<const float4*>(p + j);
        const float4 gv = *reinterpret_cast<const float4*>(g + j);
        float4 mv, vv;
        uint2 mb, vb;
        if (flags & kBf16) {
          mb = *reinterpret_cast<const uint2*>(
              static_cast<const uint16_t*>(t.leaf[l].m) + j);
          vb = *reinterpret_cast<const uint2*>(
              static_cast<const uint16_t*>(t.leaf[l].v) + j);
          mv = make_float4(bf16_lo(mb.x), bf16_hi(mb.x), bf16_lo(mb.y),
                           bf16_hi(mb.y));
          vv = make_float4(bf16_lo(vb.x), bf16_hi(vb.x), bf16_lo(vb.y),
                           bf16_hi(vb.y));
        } else {
          mv = *reinterpret_cast<const float4*>(
              static_cast<const float*>(t.leaf[l].m) + j);
          vv = *reinterpret_cast<const float4*>(
              static_cast<const float*>(t.leaf[l].v) + j);
        }
        adam_element(pv.x, gv.x, mv.x, vv.x, s);
        adam_element(pv.y, gv.y, mv.y, vv.y, s);
        adam_element(pv.z, gv.z, mv.z, vv.z, s);
        adam_element(pv.w, gv.w, mv.w, vv.w, s);
        *reinterpret_cast<float4*>(p + j) = pv;
        if (flags & kBf16) {
          // The four elements lie in one run of the innermost dim.
          const uint32_t k = flat_index(t.leaf[l], j);
          const uint32_t d = flags & kMapped ? t.leaf[l].map_stride[0] : 1u;
          mb.x = sr_bf16(mv.x, k, salt_m) | sr_bf16(mv.y, k + d, salt_m) << 16;
          mb.y = sr_bf16(mv.z, k + 2 * d, salt_m) |
                 sr_bf16(mv.w, k + 3 * d, salt_m) << 16;
          vb.x = sr_bf16(vv.x, k, salt_v) | sr_bf16(vv.y, k + d, salt_v) << 16;
          vb.y = sr_bf16(vv.z, k + 2 * d, salt_v) |
                 sr_bf16(vv.w, k + 3 * d, salt_v) << 16;
          *reinterpret_cast<uint2*>(static_cast<uint16_t*>(t.leaf[l].m) + j) = mb;
          *reinterpret_cast<uint2*>(static_cast<uint16_t*>(t.leaf[l].v) + j) = vb;
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(t.leaf[l].m) + j) = mv;
          *reinterpret_cast<float4*>(static_cast<float*>(t.leaf[l].v) + j) = vv;
        }
      }
      i = vend;
    }
    for (i += threadIdx.x; i < end; i += kThreads) {
      float pe = p[i];
      float me, ve;
      if (flags & kBf16) {
        me = bf16_lo(static_cast<const uint16_t*>(t.leaf[l].m)[i]);
        ve = bf16_lo(static_cast<const uint16_t*>(t.leaf[l].v)[i]);
      } else {
        me = static_cast<const float*>(t.leaf[l].m)[i];
        ve = static_cast<const float*>(t.leaf[l].v)[i];
      }
      adam_element(pe, g[i], me, ve, s);
      p[i] = pe;
      if (flags & kBf16) {
        const uint32_t k = flat_index(t.leaf[l], i);
        static_cast<uint16_t*>(t.leaf[l].m)[i] =
            static_cast<uint16_t>(sr_bf16(me, k, salt_m));
        static_cast<uint16_t*>(t.leaf[l].v)[i] =
            static_cast<uint16_t>(sr_bf16(ve, k, salt_v));
      } else {
        static_cast<float*>(t.leaf[l].m)[i] = me;
        static_cast<float*>(t.leaf[l].v)[i] = ve;
      }
    }
  }
}

// Blocks of a launch: as many as are resident on `sms` SMs at once, and
// no more than the chunks.
template <typename Kernel>
int grid_of(Kernel kernel, int chunks, int sms) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  return chunks < per_sm * sms ? chunks : per_sm * sms;
}

bool valid(const AdamTable* t) {
  return t != nullptr && t->leaves >= 0 && t->leaves <= kMaxLeaves &&
         t->chunks >= 0 && (t->leaves == 0 || t->chunk_end[t->leaves - 1] ==
                                                  t->chunks);
}

}  // namespace

// sizeof(AdamTable), for the wrapper's check of its own layout.
extern "C" int adam_table_bytes() { return static_cast<int>(sizeof(AdamTable)); }

// `all_finite` (one bool) := every g of the table is finite: a memset to
// true, then one launch that clears it on a non-finite element.
// (The table comes as `const void*`: a type of the unnamed namespace in
// the signature would take the entry out of the library's symbols.)
extern "C" int adam_all_finite(const void* table_bytes, bool* all_finite,
                               int sms, void* stream) {
  const AdamTable* table = static_cast<const AdamTable*>(table_bytes);
  if (!valid(table) || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(all_finite, 1, sizeof(bool), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table->chunks == 0) return 0;
  adam_finite_kernel<<<grid_of(adam_finite_kernel, table->chunks, sms),
                       kThreads, 0, st>>>(*table, all_finite);
  return static_cast<int>(cudaGetLastError());
}

// The Adam step of every leaf of the table, committed in place where *ok.
extern "C" int adam_update(const void* table_bytes, const float* c1,
                           const float* c2, const float* lr,
                           const long long* salt0, const bool* ok, int sms,
                           void* stream) {
  const AdamTable* table = static_cast<const AdamTable*>(table_bytes);
  if (!valid(table) || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (table->chunks == 0) return 0;
  adam_update_kernel<<<grid_of(adam_update_kernel, table->chunks, sms),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, c1, c2, lr, salt0, ok);
  return static_cast<int>(cudaGetLastError());
}
