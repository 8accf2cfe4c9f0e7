// Per-row (or per-column) fractional shift with zero fill, for a batch of
// images in one launch: the building block of the 3-shear BEV warp
// (heal_tpu_torch/ops/warp.py affine_warp_shear). Its backward is the same
// kernel run with -s (heal_tpu_torch/ops/shift_rows.py _Shift).
//
// Replaces the TPU kernel heal_tpu/ops/pallas_shear.py `shift_rows_pallas`
// (`_shift_rows_impl`, Pallas body `_kernel`). The Pallas kernel pads every
// row by the largest shift, loads an 8-aligned window of it into VMEM and
// resolves the remainder with a static-slice switch, one image per call.
//
// With s = shift, b = clamp(floor(s), -pad, pad), f = s - b and
// r = min(b, pad-1) (the clamps mirror heal_tpu.ops.warp._shift_rows,
// whose padded copy is pad wide and whose dynamic slice clamps its start;
// callers clip |s| <= pad - 2, where r = b):
//   axis 0: out[n, i, j, c] = (1-f)*x[n, i, j+r, c] + f*x[n, i, j+r+1, c]
//   axis 1: out[n, i, j, c] = (1-f)*x[n, i+r, j, c] + f*x[n, i+r+1, j, c]
// taps outside the image read zero. Any C works (65, 129, 257 on the
// pyramid path). The blend is two f32 products and a sum, each rounded
// (intrinsics, so no multiply-add contraction whatever the flags): the
// same arithmetic as the plain PyTorch version, to the bit.
//
// Bound on the H100: bytes. Each input element is read once and each
// output written once, at three flops: at level 0, x (4, 292, 292, 65)
// f32, that is 177 MB, 0.053 ms at 3.35 TB/s. The first version (one
// thread per element, five 64-bit divisions and a reload of the shift per
// element, two scalar taps with bounds checks) took the same time in f32
// and bf16: instruction throughput, not bytes, limited it. This design:
//   * Vectors. Element (n, i, j, c) is at position q = j*C + c of the
//     contiguous row (n, i) of L = W*C elements. A thread owns 16 bytes of
//     consecutive positions (V = 4 f32 or 8 bf16), so no division per
//     element remains, and the per-row (per-column) scalars floor, f and r
//     are computed once per block (per thread).
//   * Rows (axis 0): both taps of position q lie in the same row, at q+r*C
//     and q+(r+1)*C, with any alignment (C is odd). A block owns a tile of
//     2*256 vectors of one row, aligned in the tensor (the row's first and
//     last vectors may be partial and are stored element by element). The
//     source window (the tile plus a halo of C) is copied into shared
//     memory with 16-byte cp.async copies, zeros where it leaves the row.
//     Each thread then reads two aligned 16-byte smem vectors per tap
//     (conflict-free), picks its V taps at an offset that is the same for
//     the whole block (r*C mod V), blends, and stores one 16-byte vector.
//   * Columns (axis 1): the taps of position q are at the same q in rows
//     i+r_j and i+r_j+1, so they need no staging. A thread owns V
//     positions over a band of output rows and walks down it, carrying the
//     lower tap of row i as the upper tap of row i+1: each input vector is
//     read once per band. Its accesses are AB bytes wide, the largest of
//     16, 8, 4, 2 that divides the row's size in bytes, so that every row
//     starts AB-aligned (bf16 rows of 292*65 take 8-byte accesses). With
//     C >= V the V positions span at most two columns, whose taps come
//     from two aligned loads and a select; a row's scalar tail, and C < V,
//     read element by element.
//   * One launch for every image of a level; grids sized so that each SM
//     holds several blocks (memory-level parallelism).
#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"

namespace heal {
namespace {

constexpr int kThreads = 256;
constexpr int kRowIters = 2;  // output vectors per thread in the rows kernel

template <int BYTES>
struct Piece;
template <>
struct Piece<16> {
  using type = uint4;
};
template <>
struct Piece<8> {
  using type = uint2;
};
template <>
struct Piece<4> {
  using type = unsigned int;
};
template <>
struct Piece<2> {
  using type = unsigned short;
};

struct Tap {
  int r;    // read offset of the first tap, in rows or columns
  float f;  // weight of the second tap
};

__device__ __forceinline__ Tap tap_of(float s, int pad) {
  const float b = fminf(fmaxf(floorf(s), (float)-pad), (float)pad);
  return {min((int)b, pad - 1), __fsub_rn(s, b)};
}

__device__ __forceinline__ float blend(float v0, float v1, float f) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.f, f)), __fmul_rn(v1, f));
}

// v[e] = base[o + e] for e < V, from two aligned 16-byte vectors at base;
// o (0 <= o < V) is the same for the whole block, so the switch does not
// diverge and the taps stay in registers.
template <int O, typename T, int V>
__device__ __forceinline__ void pick_at(const T* a, float* v) {
  if constexpr (O < V) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_f32(a[O + e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void pick(const T* base, int o, float* v) {
  union {
    uint4 u[2];
    T t[2 * V];
  } a;
  a.u[0] = reinterpret_cast<const uint4*>(base)[0];
  a.u[1] = reinterpret_cast<const uint4*>(base)[1];
  switch (o) {
    case 0: pick_at<0, T, V>(a.t, v); break;
    case 1: pick_at<1, T, V>(a.t, v); break;
    case 2: pick_at<2, T, V>(a.t, v); break;
    case 3: pick_at<3, T, V>(a.t, v); break;
    case 4: pick_at<4, T, V>(a.t, v); break;
    case 5: pick_at<5, T, V>(a.t, v); break;
    case 6: pick_at<6, T, V>(a.t, v); break;
    default: pick_at<7, T, V>(a.t, v); break;
  }
}

// V values to dst (16-byte aligned) as one 16-byte store
template <typename T, int V>
__device__ __forceinline__ void store16(T* dst, const float* y) {
  union {
    uint4 u;
    T t[V];
  } o;
#pragma unroll
  for (int e = 0; e < V; ++e) o.t[e] = from_f32<T>(y[e]);
  *reinterpret_cast<uint4*>(dst) = o.u;
}

template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int rows_tile() {
  return kThreads * kRowIters * vec_of<T>();
}

// shared-memory elements of the rows kernel's window: the tile, a halo of
// C, and 3V for rounding its ends to 16 bytes and the second smem vector
template <typename T>
int rows_smem_bytes(int c) {
  const int elems = rows_tile<T>() + c + 3 * vec_of<T>();
  return (elems * (int)sizeof(T) + 15) / 16 * 16;
}

// Rows: a block owns kTile consecutive outputs of one row, in 16-byte
// vectors aligned in the tensor (a row's first and last may be partial).
// Positions are in-row ints; d is the row start's offset in its vector.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    shift_rows_kernel(const T* __restrict__ x, const float* __restrict__ shifts,
                      T* __restrict__ out, int len, int c, int pad,
                      int chunks) {
  constexpr int V = vec_of<T>();
  constexpr int kTile = rows_tile<T>();
  extern __shared__ uint4 smem_u4[];
  T* win = reinterpret_cast<T*>(smem_u4);

  const unsigned row = blockIdx.x / (unsigned)chunks;
  const int chunk = (int)(blockIdx.x - row * (unsigned)chunks);
  const long long r0 = (long long)row * len;
  const int d = (int)(r0 & (V - 1));
  const T* src = x + r0;
  T* dst = out + r0;
  // the block's outputs [q0, q1); q + d is a multiple of V for every
  // thread's vector, so src + q and dst + q are 16-byte aligned
  const int q0 = chunk * kTile - d;
  const int q1 = min(q0 + kTile, len);
  const Tap t = tap_of(shifts[row], pad);
  const int rc = t.r * c;
  // source window [ws, we), aligned like the outputs; zeros off the row
  const int ws = ((q0 + rc + d) & -V) - d;
  const int we = ((q1 + d + V - 1) & -V) - d + rc + c + V;
  for (int p = ws + (int)threadIdx.x * V; p < we; p += kThreads * V) {
    T* w = win + (p - ws);
    if (p >= 0 && p + V <= len) {
      __pipeline_memcpy_async(w, src + p, 16);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        w[e] = (p + e >= 0 && p + e < len) ? src[p + e] : from_f32<T>(0.f);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int o0 = rc & (V - 1);
  const int o1 = (rc + c) & (V - 1);
#pragma unroll
  for (int k = 0; k < kRowIters; ++k) {
    const int q = q0 + (k * kThreads + (int)threadIdx.x) * V;
    if (q >= q1) break;
    float v0[V], v1[V], y[V];
    pick<T, V>(win + (q + rc - ws - o0), o0, v0);
    pick<T, V>(win + (q + rc + c - ws - o1), o1, v1);
#pragma unroll
    for (int e = 0; e < V; ++e) y[e] = blend(v0[e], v1[e], t.f);
    if (q >= 0 && q + V <= len) {
      store16<T, V>(dst + q, y);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (q + e >= 0 && q + e < len) dst[q + e] = from_f32<T>(y[e]);
    }
  }
}

// 16 bytes of taps, kept in the input type
template <typename T, int AB>
union Raw {
  typename Piece<AB>::type p[16 / AB];
  T t[16 / sizeof(T)];
};

// the V values of source row sr at the thread's positions (zeros outside
// the image); img points at the thread's first position in row 0
template <typename T, int AB>
__device__ __forceinline__ Raw<T, AB> row_raw(const T* img, int sr, int h,
                                              int len) {
  Raw<T, AB> a;
  if (sr >= 0 && sr < h) {
    using P = typename Piece<AB>::type;
    const P* s = reinterpret_cast<const P*>(img + (long long)sr * len);
#pragma unroll
    for (int k = 0; k < 16 / AB; ++k) a.p[k] = s[k];
  } else {
#pragma unroll
    for (int k = 0; k < 16 / AB; ++k) a.p[k] = {};
  }
  return a;
}

// Columns: a thread owns V positions of the rows of one image and walks
// down a band of output rows.
template <typename T, int AB>
__global__ void __launch_bounds__(kThreads, 4)
    shift_cols_kernel(const T* __restrict__ x, const float* __restrict__ shifts,
                      T* __restrict__ out, int h, int w, int c, int pad,
                      int spans, int band, int bands) {
  constexpr int V = vec_of<T>();
  const int len = w * c;
  unsigned b = blockIdx.x;
  const int span = (int)(b % (unsigned)spans);
  b /= (unsigned)spans;
  const int i0 = (int)(b % (unsigned)bands) * band;
  const int n = (int)(b / (unsigned)bands);
  const int q = (span * kThreads + (int)threadIdx.x) * V;
  if (q >= len) return;
  const int i1 = min(i0 + band, h);
  const long long img_off = (long long)n * h * len + q;
  const T* img = x + img_off;
  T* dst = out + img_off;
  const float* srow = shifts + (long long)n * w;

  if (c < V || q + V > len) {
    // C < V, or the row's tail: element by element, no carry
    for (int e = 0; e < V && q + e < len; ++e) {
      const Tap t = tap_of(srow[(q + e) / c], pad);
      for (int i = i0; i < i1; ++i) {
        const int a = i + t.r;
        const float v0 =
            (a >= 0 && a < h) ? to_f32(img[(long long)a * len + e]) : 0.f;
        const float v1 = (a + 1 >= 0 && a + 1 < h)
                             ? to_f32(img[(long long)(a + 1) * len + e])
                             : 0.f;
        dst[(long long)i * len + e] = from_f32<T>(blend(v0, v1, t.f));
      }
    }
    return;
  }
  // C >= V: the V positions span one or two columns; positions [0, split)
  // are in the first (taps at rows i + ra), the rest in the second
  const int j0 = q / c;
  const int split = min(V, (j0 + 1) * c - q);
  const Tap ta = tap_of(srow[j0], pad);
  const Tap tb = tap_of(srow[min(j0 + 1, w - 1)], pad);
  const bool two = split < V && tb.r != ta.r;
  auto taps = [&](int i) {
    Raw<T, AB> v = row_raw<T, AB>(img, i + ta.r, h, len);
    if (two) {
      const Raw<T, AB> u = row_raw<T, AB>(img, i + tb.r, h, len);
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e >= split) v.t[e] = u.t[e];
    }
    return v;
  };
  Raw<T, AB> lo = taps(i0);
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const Raw<T, AB> hi = taps(i + 1);
    Raw<T, AB> o;
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.t[e] = from_f32<T>(blend(to_f32(lo.t[e]), to_f32(hi.t[e]),
                                 e < split ? ta.f : tb.f));
    using P = typename Piece<AB>::type;
    P* d = reinterpret_cast<P*>(dst + (long long)i * len);
#pragma unroll
    for (int k = 0; k < 16 / AB; ++k) d[k] = o.p[k];
    lo = hi;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

template <typename T, int AB>
int launch_ab(const T* x, const float* shifts, T* out, int n, int h, int w,
              int c, int axis, int pad, cudaStream_t stream) {
  constexpr int V = vec_of<T>();
  const int len = w * c;
  if (axis == 0) {
    // a row's vectors span at most len + V - 1 elements
    const int chunks = (len + V - 1 + rows_tile<T>() - 1) / rows_tile<T>();
    const long long blocks = (long long)n * h * chunks;
    const int smem = rows_smem_bytes<T>(c);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          shift_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    shift_rows_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
        x, shifts, out, len, c, pad, chunks);
  } else {
    const int spans = (len + kThreads * V - 1) / (kThreads * V);
    // bands short enough for some 32 blocks per SM (eight waves of four),
    // and at least 4 rows long, so that the carried taps save most
    // re-reads (tuned on the H100 at the pyramid's shapes)
    const long long target = 32LL * sm_count();
    int band = (int)((long long)n * h * spans / target);
    band = band < 4 ? 4 : (band > 32 ? 32 : band);
    const int bands = (h + band - 1) / band;
    const long long blocks = (long long)n * bands * spans;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    shift_cols_kernel<T, AB><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, shifts, out, h, w, c, pad, spans, band, bands);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shift_rows(const void* x, const void* shifts, void* out, int n,
                      int h, int w, int c, int axis, int pad, void* stream) {
  const long long len = (long long)w * c;
  if ((long long)n * h * len == 0) return (int)cudaGetLastError();
  // row positions and offsets r*C stay in int; x and out 16-byte aligned
  if (len + 2LL * (pad + 2) * c >= (1LL << 30) || (axis != 0 && axis != 1) ||
      ((uintptr_t)x | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  const float* ss = static_cast<const float*>(shifts);
  T* os = static_cast<T*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  // widest access that keeps every row start aligned
  const long long row_bytes = len * (long long)sizeof(T);
  if (row_bytes % 16 == 0)
    return launch_ab<T, 16>(xs, ss, os, n, h, w, c, axis, pad, st);
  if (row_bytes % 8 == 0)
    return launch_ab<T, 8>(xs, ss, os, n, h, w, c, axis, pad, st);
  if (row_bytes % 4 == 0)
    return launch_ab<T, 4>(xs, ss, os, n, h, w, c, axis, pad, st);
  if constexpr (sizeof(T) == 2)
    return launch_ab<T, 2>(xs, ss, os, n, h, w, c, axis, pad, st);
  return (int)cudaErrorInvalidValue;  // unreachable: f32 rows are 4-aligned
}

}  // namespace
}  // namespace heal

extern "C" int heal_shift_rows_f32(const void* x, const void* shifts,
                                   void* out, int n, int h, int w, int c,
                                   int axis, int pad, void* stream) {
  return heal::launch_shift_rows<float>(x, shifts, out, n, h, w, c, axis, pad,
                                        stream);
}

extern "C" int heal_shift_rows_bf16(const void* x, const void* shifts,
                                    void* out, int n, int h, int w, int c,
                                    int axis, int pad, void* stream) {
  return heal::launch_shift_rows<__nv_bfloat16>(x, shifts, out, n, h, w, c,
                                                axis, pad, stream);
}
