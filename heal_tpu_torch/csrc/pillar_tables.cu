// Pillar tables: segmented max / sum over presorted pillar runs, with the
// PointPillars per-pillar epilogue, written as the whole dense BEV canvas.
//
// Replaces the TPU kernel heal_tpu/ops/pallas_pillar.py `pillar_tables`
// (Pallas body `_kernel`) and the sorted scatter-add that expands its rows
// onto the canvas (heal_tpu/models/encoders.py `_pallas_eval`). That kernel
// streams blocks of 512 points in order over one TPU core, carries the
// unfinished run across blocks in VMEM and emits (cell, value) rows; blocks
// on a GPU run in no order, so nothing can be carried between them.
//
// Per canvas row samp*stride + cin, with id = samp*cells + cin the row's
// table-space pillar id, the run of points p with fi[p] == id, and W1 =
// rows 0-2, W2 = rows 3-5, b = row 6 of `wts` (7, F):
//   canvas[row, c] =
//     relu(max_p u[p, c] - (sum_p g[p, :3]) @ W1[:, c] / max(sum_p g[p, 3], 1)
//          + center(cin) @ W2[:, c] + b[c])
// with center(cin) = (xi*vx + cx0, yi*vy + cy0, cz), cin = yi*nx + xi, and
// zero for a row with no points. Drop-bucket ids (cin >= stride), ids past
// the last sample and negative ids land on no row.
//
// Bound on the H100: bytes. At the flagship shapes (5 samples of a 512x256
// grid, F = 64) the canvas alone is 168 MB in f32 (84 MB in bf16), some 98%
// of what the function must move on a served frame; the points that land
// on it add a few MB, and up to 41 MB on a frame as dense as OPV2V lidar.
// The design parallelises over the output, so that every canvas row is
// written exactly once, with no zero fill beforehand and no host sync, in
// one launch. A block owns a tile of 256 consecutive canvas rows:
//   1. One warp per search key finds the tile's point range with a 32-way
//      search over the sorted ids (4 dependent loads for 150k points), one
//      range per sample the tile touches, so the drop bucket and the
//      padding between two samples are never read.
//   2. The block copies those points' u and g4 rows into shared memory
//      with cp.async (when they fit, on the 16-byte path) and, while the
//      copies fly, scans their ids once, listing each run (row, start) and
//      its end and marking its row busy. Read straight from device memory
//      behind the canvas' write stream, each busy row waited a round trip.
//   3. Groups of G lanes (G = the 16-byte chunks of a row, rounded up to a
//      power of two: 16 for F = 64 f32, 8 for bf16) take the busy rows: the
//      channel max in f32 with one 16-byte load per lane and point, the g4
//      sums with the lanes splitting the points and reducing by shuffles,
//      in a fixed order (two calls give the same bits), then the epilogue
//      with the weights from shared memory, one weight row at a time (few
//      live registers: the bf16 kernel keeps 5 blocks an SM). Then every
//      other row gets one 16-byte zero store per lane, so a warp stores 512
//      contiguous bytes at a time.
//   Stores are streaming (st.global.cs, evict first): the canvas is larger
//   than L2 and only the next layer reads it. On the H100 they brought the
//   served frame to within a few per cent of a kernel that only stores the
//   canvas, which write-back stores did not. Pipelining the next tile's
//   search in a persistent block, 128- or 512-row tiles, and register caps
//   for more blocks an SM were each slower at these shapes.
//   An F or an alignment the 16-byte path does not take (F = 10, a
//   misaligned u) runs the same kernel one element per lane, unstaged.
#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"

namespace heal {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;          // canvas rows a block writes
constexpr int kStageBytes = 24576;  // shared memory for a tile's points

// First p in [0, n) with fi[p] >= key (n if none), by one whole warp:
// each round probes 32 evenly spaced ids and keeps the gap that holds the
// answer, so the span shrinks 33-fold a round.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ fi,
                                                int n, int key, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int pos = lo + (int)((lane + 1) * span / 33);
    const unsigned less = __ballot_sync(0xffffffffu, fi[pos] < key);
    const int c = __popc(less);  // the ids are sorted: a prefix of probes
    const int new_lo = c == 0 ? lo : lo + (int)(c * span / 33) + 1;
    hi = c == 32 ? hi : lo + (int)((c + 1) * span / 33);
    lo = new_lo;
  }
  const bool less = lane < hi - lo && fi[lo + lane] < key;
  return lo + __popc(__ballot_sync(0xffffffffu, less));
}

// V consecutive values of T as one access: 16 bytes when V > 1
template <typename T, int V>
struct Raw {
  union {
    uint4 q;
    T t[V];
  };
};
template <typename T>
struct Raw<T, 1> {
  T t[1];
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  Raw<T, V> a;
  if constexpr (V == 1) {
    a.t[0] = *p;
  } else {
    a.q = *reinterpret_cast<const uint4*>(p);
  }
  return a;
}

// W = 1 or 4 floats of shared memory (16-byte aligned when 4)
template <int W>
__device__ __forceinline__ void load_w(const float* p, float* w) {
  if constexpr (W == 1) {
    w[0] = *p;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    w[0] = a.x;
    w[1] = a.y;
    w[2] = a.z;
    w[3] = a.w;
  }
}

// streaming stores: evict first, the canvas does not fit in L2
template <typename T, int V>
__device__ __forceinline__ void store_vals(T* p, const float* v) {
  Raw<T, V> a;
#pragma unroll
  for (int e = 0; e < V; ++e) a.t[e] = from_f32<T>(v[e]);
  if constexpr (V == 1) {
    *p = a.t[0];
  } else {
    __stcs(reinterpret_cast<uint4*>(p), a.q);
  }
}

// V = 16 / sizeof(T) (rows of 16-byte chunks, u and out 16-byte aligned)
// or 1; a row is F / V units, each owned by one lane of its row's group of
// G lanes (G a power of two, at most 32; lanes loop when F / V > 32).
// Dynamic shared memory: the weights (7 F floats), then `stage_pts` g4
// rows and u rows (none when V == 1).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) pillar_tables_kernel(
    const T* __restrict__ u,        // (N, F) per-point max channels
    const float4* __restrict__ g4,  // (N,) (w*local_xyz, w)
    const int* __restrict__ fi,     // (N,) sorted table-space pillar ids
    const float* __restrict__ wts,  // (7, F) W1, W2, b
    T* __restrict__ out,            // (rows, F) canvas, every row written
    int n, int feat, int g, int nx, int stride, int cells, int rows,
    int stage_pts, float vx, float vy, float cx0, float cy0, float cz) {
  __shared__ int2 busy[kTile];       // busy rows: (row in the tile, start)
  __shared__ int end[kTile];         // each busy row's run end
  __shared__ unsigned mask[kTile / 32];
  __shared__ int bounds[2 * kTile];  // point range of each sample's part
  __shared__ int nbusy;
  extern __shared__ uint4 dyn[];
  float* sw = reinterpret_cast<float*>(dyn);
  float4* sg = reinterpret_cast<float4*>(sw + (7 * feat + 3) / 4 * 4);
  T* su = reinterpret_cast<T*>(sg + stage_pts);

  const int r0 = blockIdx.x * kTile;
  const int nrows = min(kTile, rows - r0);
  const int s_first = r0 / stride;
  const int nseg = (r0 + nrows - 1) / stride - s_first + 1;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < 7 * feat; i += kThreads) sw[i] = wts[i];
  if (threadIdx.x < kTile / 32) mask[threadIdx.x] = 0u;
  if (threadIdx.x == 0) nbusy = 0;
  // the tile's rows of sample s are ids [s*cells + ca, s*cells + cb)
  for (int k = threadIdx.x >> 5; k < 2 * nseg; k += kThreads / 32) {
    const int s = s_first + (k >> 1);
    const int row = (k & 1) ? min(r0 + nrows, (s + 1) * stride)
                            : max(r0, s * stride);
    bounds[k] = warp_lower_bound(fi, n, s * cells + (row - s * stride), lane);
  }
  __syncthreads();

  // stage the landed points if they fit: segment k's points [a, b) go to
  // [base, base + b - a) of the stage, so point p is at p - a + base
  int total = 0;
  for (int k = 0; k < nseg; ++k) total += bounds[2 * k + 1] - bounds[2 * k];
  const bool staged = V > 1 && total <= stage_pts;
  const int chunks = feat / V;  // 16-byte chunks of a u row when V > 1
  if (staged) {
    for (int k = 0, base = 0; k < nseg; ++k) {
      const int a = bounds[2 * k], b = bounds[2 * k + 1];
      for (int i = threadIdx.x; i < b - a; i += kThreads)
        __pipeline_memcpy_async(sg + base + i, g4 + a + i, 16);
      for (int i = threadIdx.x; i < (b - a) * chunks; i += kThreads)
        __pipeline_memcpy_async(su + (long long)base * feat + i * V,
                                u + (long long)a * feat + i * V, 16);
      base += b - a;
    }
    __pipeline_commit();
  }
  for (int k = 0, base = 0; k < nseg; ++k) {
    const int a = bounds[2 * k], b = bounds[2 * k + 1];
    const int off = (s_first + k) * (cells - stride) + r0;  // id -> tile row
    const int shift = staged ? base - a : 0;                // point -> index
    for (int p = a + (int)threadIdx.x; p < b; p += kThreads) {
      const int v = fi[p];
      const int r = v - off;
      if ((unsigned)r >= (unsigned)nrows) continue;  // unsorted input
      if (p == a || fi[p - 1] != v) {
        const int slot = atomicAdd(&nbusy, 1);
        if (slot < kTile) busy[slot] = make_int2(r, p + shift);
        atomicOr(&mask[r >> 5], 1u << (r & 31));
      }
      if (p == b - 1 || fi[p + 1] != v) end[r] = p + 1 + shift;
    }
    base += b - a;
  }
  if (staged) __pipeline_wait_prior(0);
  __syncthreads();

  const T* us = staged ? su : u;
  const float4* gs = staged ? sg : g4;
  const int lg = threadIdx.x & (g - 1);
  const int ngroups = kThreads / g;
  const unsigned gmask =
      g == 32 ? 0xffffffffu : ((1u << g) - 1) << (lane & ~(g - 1));
  const int units = feat / V;
  const int nb = min(nbusy, kTile);
  for (int i = threadIdx.x / g; i < nb; i += ngroups) {
    const int r = busy[i].x;
    const int p0 = busy[i].y;
    const int p1 = end[r];
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, cnt = 0.f;
    for (int p = p0 + lg; p < p1; p += g) {
      const float4 q = gs[p];
      s0 += q.x;
      s1 += q.y;
      s2 += q.z;
      cnt += q.w;
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
      s0 += __shfl_xor_sync(gmask, s0, o);
      s1 += __shfl_xor_sync(gmask, s1, o);
      s2 += __shfl_xor_sync(gmask, s2, o);
      cnt += __shfl_xor_sync(gmask, cnt, o);
    }
    const int row = r0 + r;
    const int cin = row - (row / stride) * stride;
    const int yi = cin / nx;
    const int xi = cin - yi * nx;
    const float cx = xi * vx + cx0;
    const float cy = yi * vy + cy0;
    const float den = fmaxf(cnt, 1.f);
    T* dst = out + (long long)row * feat;
    for (int c = lg; c < units; c += g) {
      float m[V];
#pragma unroll
      for (int e = 0; e < V; ++e) m[e] = -INFINITY;
      const T* up = us + (long long)p0 * feat + c * V;
#pragma unroll 4
      for (int p = p0; p < p1; ++p, up += feat) {
        const Raw<T, V> x = load_raw<T, V>(up);
#pragma unroll
        for (int e = 0; e < V; ++e) m[e] = fmaxf(m[e], to_f32(x.t[e]));
      }
      constexpr int W = V == 1 ? 1 : 4;  // channels per weight load
      const float sc[6] = {s0, s1, s2, cx, cy, cz};
#pragma unroll
      for (int k = 0; k < V; k += W) {
        // -(s0 w0 + s1 w1 + s2 w2) / den + (cx w3 + cy w4 + cz w5) + w6,
        // summed left to right, one weight row at a time
        float acc[2][W], w[W];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          load_w<W>(sw + j * feat + c * V + k, w);
#pragma unroll
          for (int e = 0; e < W; ++e)
            acc[j / 3][e] =
                j % 3 ? acc[j / 3][e] + sc[j] * w[e] : sc[j] * w[e];
        }
        load_w<W>(sw + 6 * feat + c * V + k, w);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float tb = -acc[0][e] / den + acc[1][e] + w[e];
          const float x = m[k + e];
          m[k + e] = isfinite(x) ? fmaxf(x + tb, 0.f) : 0.f;
        }
      }
      store_vals<T, V>(dst + c * V, m);
    }
  }
  const float zero[V] = {};
  for (int k = threadIdx.x / g; k < nrows; k += ngroups) {
    if ((mask[k >> 5] >> (k & 31)) & 1u) continue;
    T* dst = out + (long long)(r0 + k) * feat;
    for (int c = lg; c < units; c += g) store_vals<T, V>(dst + c * V, zero);
  }
}

template <typename T, int V>
int launch(const T* u, const float4* g4, const int* fi, const float* wts,
           T* out, int n, int feat, int g, int nx, int stride, int cells,
           int rows, float vx, float vy, float cx0, float cy0, float cz,
           cudaStream_t st) {
  const int wbytes = (7 * feat + 3) / 4 * 16;
  const int stage_pts =
      V > 1 ? kStageBytes / (16 + feat * (int)sizeof(T)) : 0;
  const int smem = wbytes + stage_pts * (16 + feat * (int)sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pillar_tables_kernel<T, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((rows + kTile - 1) / kTile);
  pillar_tables_kernel<T, V><<<blocks, kThreads, smem, st>>>(
      u, g4, fi, wts, out, n, feat, g, nx, stride, cells, rows, stage_pts,
      vx, vy, cx0, cy0, cz);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pillar_tables(const void* u, const void* g4, const void* fi,
                         const void* wts, void* out, int n, int feat, int nx,
                         int stride, int cells, int batch, float vx, float vy,
                         float cx0, float cy0, float cz, void* stream) {
  const long long rows = (long long)batch * stride;
  // ids, rows and point offsets stay in int; the weights in shared memory
  if (n < 0 || feat <= 0 || feat > 4096 || batch < 0 || stride < 0 ||
      cells < stride || (long long)batch * cells >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = feat % V == 0 && ((uintptr_t)u | (uintptr_t)out) % 16 == 0;
  const int units = vec ? feat / V : feat;
  int g = 1;
  while (g < units && g < 32) g <<= 1;
  const T* us = static_cast<const T*>(u);
  const float4* gs = static_cast<const float4*>(g4);
  const int* fs = static_cast<const int*>(fi);
  const float* ws = static_cast<const float*>(wts);
  T* os = static_cast<T*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    return launch<T, V>(us, gs, fs, ws, os, n, feat, g, nx, stride, cells,
                        (int)rows, vx, vy, cx0, cy0, cz, st);
  return launch<T, 1>(us, gs, fs, ws, os, n, feat, g, nx, stride, cells,
                      (int)rows, vx, vy, cx0, cy0, cz, st);
}

}  // namespace
}  // namespace heal

extern "C" int heal_pillar_tables_f32(const void* u, const void* g4,
                                      const void* fi, const void* wts,
                                      void* out, int n, int feat, int nx,
                                      int stride, int cells, int batch,
                                      float vx, float vy, float cx0, float cy0,
                                      float cz, void* stream) {
  return heal::launch_pillar_tables<float>(u, g4, fi, wts, out, n, feat, nx,
                                           stride, cells, batch, vx, vy, cx0,
                                           cy0, cz, stream);
}

extern "C" int heal_pillar_tables_bf16(const void* u, const void* g4,
                                       const void* fi, const void* wts,
                                       void* out, int n, int feat, int nx,
                                       int stride, int cells, int batch,
                                       float vx, float vy, float cx0,
                                       float cy0, float cz, void* stream) {
  return heal::launch_pillar_tables<__nv_bfloat16>(
      u, g4, fi, wts, out, n, feat, nx, stride, cells, batch, vx, vy, cx0,
      cy0, cz, stream);
}
