// Pillar tables: segmented max / sum over presorted pillar runs, with the
// PointPillars per-pillar epilogue, written straight into the BEV canvas.
//
// Replaces the TPU kernel heal_tpu/ops/pallas_pillar.py `pillar_tables`
// (Pallas body `_kernel`). That kernel streams blocks of 512 points in
// order over one TPU core, carries the unfinished run across blocks in
// VMEM, emits (cell, value) rows and leaves the expansion onto the canvas
// to a sorted XLA scatter-add. Blocks on a GPU run in no order, so nothing
// can be carried between them. Here each run of equal pillar ids is one
// thread block instead: the host side builds the run-start offsets, and a
// block loops over its run's points, threads over the F channels, taking
// the max of `u` and the sum of `g4` in f32. Each real cell is exactly one
// run (ids are monotone), so the block writes its final row to the zeroed
// (batch*stride, F) canvas directly: no atomics, no separate scatter.
// Runs in the drop bucket (within-sample cell >= stride) or past the last
// sample (padding sentinel) write nothing.
//
// Bound on the H100: bytes. It reads u once (N*F*sizeof(T)) and g4 (N*16
// bytes) and writes one F-row per pillar; the arithmetic is a few flops a
// byte. Threads over channels make each point's F-row one coalesced load;
// the long drop-bucket run (the padded points of every agent) is skipped
// before its points are touched, so its bytes are never read.
//
// Per run, with W1 = rows 0-2, W2 = rows 3-5, b = row 6 of `wts` (7, F):
//   canvas[samp*stride + cin, c] =
//     relu(max_p u[p, c] - (sum_p g[p, :3]) @ W1[:, c] / max(sum_p g[p, 3], 1)
//          + center(cin) @ W2[:, c] + b[c])
// with center(cin) = (xi*vx + cx0, yi*vy + cy0, cz), cin = yi*nx + xi.
#include <stdint.h>

#include "common.cuh"

namespace heal {

template <typename T>
__global__ void pillar_tables_kernel(
    const T* __restrict__ u,          // (N, F) per-point max channels
    const float4* __restrict__ g4,    // (N,) (w*local_xyz, w)
    const int* __restrict__ fi,       // (N,) sorted table-space pillar ids
    const int* __restrict__ starts,   // (R+1,) run offsets, last = N
    const float* __restrict__ wts,    // (7, F) W1, W2, b
    T* __restrict__ out,              // (batch*stride, F), zeroed
    int feat, int nx, int stride, int cells, int batch,
    float vx, float vy, float cx0, float cy0, float cz) {
  const int p0 = starts[blockIdx.x];
  const int p1 = starts[blockIdx.x + 1];
  const int id = fi[p0];
  if (id < 0) return;
  const int samp = id / cells;
  const int cin = id - samp * cells;
  if (samp >= batch || cin >= stride) return;  // drop bucket / sentinel

  // every thread sums the run's g4 rows itself: the loads are one
  // broadcast address per warp, and no shared-memory exchange is needed
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, cnt = 0.f;
  for (int p = p0; p < p1; ++p) {
    const float4 g = g4[p];
    s0 += g.x;
    s1 += g.y;
    s2 += g.z;
    cnt += g.w;
  }
  const int yi = cin / nx;
  const int xi = cin - yi * nx;
  const float cx = xi * vx + cx0;
  const float cy = yi * vy + cy0;
  const float den = fmaxf(cnt, 1.f);
  T* row = out + ((long long)samp * stride + cin) * feat;

  for (int c = threadIdx.x; c < feat; c += blockDim.x) {
    float m = -INFINITY;
    for (int p = p0; p < p1; ++p) {
      m = fmaxf(m, to_f32(u[(long long)p * feat + c]));
    }
    const float t =
        -(s0 * wts[c] + s1 * wts[feat + c] + s2 * wts[2 * feat + c]) / den +
        (cx * wts[3 * feat + c] + cy * wts[4 * feat + c] +
         cz * wts[5 * feat + c]) +
        wts[6 * feat + c];
    row[c] = from_f32<T>(fmaxf(m + t, 0.f));
  }
}

template <typename T>
int launch_pillar_tables(const void* u, const void* g4, const void* fi,
                         const void* starts, const void* wts, void* out,
                         int n_runs, int feat, int nx, int stride, int cells,
                         int batch, float vx, float vy, float cx0, float cy0,
                         float cz, void* stream) {
  if (n_runs > 0) {
    int threads = ((feat + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    pillar_tables_kernel<T><<<n_runs, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(u), static_cast<const float4*>(g4),
        static_cast<const int*>(fi), static_cast<const int*>(starts),
        static_cast<const float*>(wts), static_cast<T*>(out), feat, nx,
        stride, cells, batch, vx, vy, cx0, cy0, cz);
  }
  return (int)cudaGetLastError();
}

}  // namespace heal

extern "C" int heal_pillar_tables_f32(
    const void* u, const void* g4, const void* fi, const void* starts,
    const void* wts, void* out, int n_runs, int feat, int nx, int stride,
    int cells, int batch, float vx, float vy, float cx0, float cy0, float cz,
    void* stream) {
  return heal::launch_pillar_tables<float>(u, g4, fi, starts, wts, out,
                                           n_runs, feat, nx, stride, cells,
                                           batch, vx, vy, cx0, cy0, cz,
                                           stream);
}

extern "C" int heal_pillar_tables_bf16(
    const void* u, const void* g4, const void* fi, const void* starts,
    const void* wts, void* out, int n_runs, int feat, int nx, int stride,
    int cells, int batch, float vx, float vy, float cx0, float cy0, float cz,
    void* stream) {
  return heal::launch_pillar_tables<__nv_bfloat16>(
      u, g4, fi, starts, wts, out, n_runs, feat, nx, stride, cells, batch, vx,
      vy, cx0, cy0, cz, stream);
}
