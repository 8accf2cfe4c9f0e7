// Kernel 3: one layer of SECOND's column engine (models/second.py
// ColumnConvLayer) in one launch: the 3x3x3 sparse conv on BEV columns
// (submanifold, or strided k=3 s=2 p=1), then LayerNorm over the output
// channels (eps as given, statistics in f32 as E[x^2] - E[x]^2), ReLU and
// the occupancy mask, one store of the layer's output
// (heal_tpu_torch/ops/column_conv.py column_conv_layer; its plain version
// column_conv_layer_plain composes subm_conv / strided_conv and the
// layer's epilogue in PyTorch ops).
//
// Replaces no TPU kernel: JAX's column engine (heal_tpu/ops/column_conv.py)
// is XLA ops. The plain version z-stacks every input row, runs nine
// separate (rows*Z, 3*Cin) x (3*Cin, Cout) products over every capacity
// row of every agent slot, writes each product to memory, gathers it back
// per tap and adds the nine, then the bias-free LayerNorm, ReLU and masks
// as separate passes: on the published m3 (channels 16/32/64/64, z layers
// 40/20/10/5, capacities 24000/16000/12000/8000, 5 slots) about 770 GFLOP
// and 136 GB of traffic a forward, of which the one real agent needs
// about 140 GFLOP.
//
// Bound on the H100. Only the occupied output voxels need products
// (2*27*Cin*Cout f32 operations each; every other output is 0), so the
// function's bound is the larger of those at 67 TFLOP/s and the bytes (a
// few hundred MB of inputs and outputs a forward, ~0.1 ms at 3.35 TB/s);
// on a dense frame's 64 -> 64 layer that is the occupied voxels'
// products. This design computes whole warps of z layers: every voxel of
// the valid columns (Z dense, as the engine keeps it), ~140 GFLOP a
// forward, 2.1 ms at that rate, whenever a warp holds one occupied voxel,
// so it sits well below the function's bound; gathering the occupied
// voxels themselves into the warps is the room left. Tensor cores are not
// used: the configuration states f32 with TF32 off. Design:
//   * A block owns `cb` consecutive output columns of one agent, all their
//     z layers and all Cout channels. Thread (group v, lane cl) owns kTM
//     consecutive z layers of one column and kTN = 8 channels (two float4
//     at cl*4 and Cout/2 + cl*4, so the lanes of a quarter warp read one
//     128-byte row of weights); the Cout/8 lanes of a voxel are
//     neighbours in the warp. Groups run column-fastest, so a warp spans
//     several columns at one band of z.
//   * For each of the 9 (dy, dx) taps of the level's table (column_table
//     or strided_table, miss = Vc) and each chunk of up to 32 input
//     channels, the block stages the neighbour columns' (Z + 2, chunk)
//     slabs (zero rows past the grid and for a miss; odd strides, so the
//     warp's columns fall in distinct banks) and the tap's three dz
//     weight blocks, read in their stored (27, Cin, Cout) order, into
//     shared memory. Each thread then loads its input rows once per
//     channel (kTM + 2 rows, or 2*kTM + 1 for the strided windows
//     in[2z - 1 + k]) and reuses each row across the three dz taps:
//     3*kTM*kTN explicit FMAs (__fmaf_rn; the build has --fmad=false,
//     under which a*b + c would be a separate multiply and add) per 7 or 11
//     scalar and 6 vector loads. The sum stays in registers over all 27
//     taps: nothing is written between taps.
//   * Epilogue in registers: LayerNorm with the channel sums reduced
//     across the voxel's lanes by shuffles, ReLU, the mask, one store
//     (the strided layer also stores its output occupancy, the max of the
//     input occupancy over the 3x3x3 field, as strided_conv computes it).
//   * Empty work is skipped on the card with no host sync. An agent's
//     valid columns are a prefix of its rows, so a tile whose first
//     column is invalid (every empty slot, the padded tail) only writes
//     zeros. Within valid columns a warp whose output voxels are all
//     unoccupied skips the products (their outputs are zeros: LayerNorm
//     of a zero vector gives the bias, which the mask then zeroes), and a
//     block whose voxels are all unoccupied skips the staging too. Every
//     occupied voxel gets the plain version's value up to the order of
//     the f32 sums.
#include <stdint.h>

#include "common.cuh"

namespace heal {
namespace {

constexpr int kThreads = 256;
// z layers a thread owns: the published grid's 40, 20, 10 and 5 layers
// are multiples of 5, so no thread of those levels idles
constexpr int kTM = 5;
constexpr int kTN = 8;  // output channels a thread owns
constexpr unsigned kFull = 0xffffffffu;

template <int CIN, int COUT, bool STRIDED>
struct Shape {
  static constexpr int kLanes = COUT / kTN;       // threads of one voxel
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr int kChunk = CIN < 32 ? CIN : 32;  // channels staged
  static constexpr int kRowStride = kChunk + 1;   // odd: no bank conflicts
  // input rows a thread reads per channel
  static constexpr int kRows = STRIDED ? 2 * kTM + 1 : kTM + 2;
  // a lane's two float4 of channels lie in the two halves of COUT
  static_assert(COUT % (2 * kTN) == 0 && kLanes <= 32 &&
                    (32 % kLanes) == 0 && CIN % kChunk == 0 &&
                    kChunk % 4 == 0,
                "unsupported channel widths");
};

// rows of a column's staged slab: input layers -1 .. the last one read
__host__ __device__ inline int slab_rows(int zg, bool strided) {
  return strided ? 2 * zg * kTM + 1 : zg * kTM + 2;
}

// an odd column stride, so the warp's columns fall in distinct banks
__host__ __device__ inline int col_stride(int rows, int row_stride) {
  return (rows * row_stride) | 1;
}

template <int CIN, int COUT, bool STRIDED>
__global__ void __launch_bounds__(kThreads, 2)
    column_conv_kernel(const float* __restrict__ feats,
                       const uint8_t* __restrict__ occ,
                       const int* __restrict__ table,
                       const float* __restrict__ wts,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, uint8_t* __restrict__ out_occ,
                       int vc, int ocap, int z, int zo, int cb, int zg,
                       float eps) {
  using S = Shape<CIN, COUT, STRIDED>;
  constexpr int NL = S::kLanes, KC = S::kChunk, RS = S::kRowStride;
  const int rows = slab_rows(zg, STRIDED);
  const int cs = col_stride(rows, RS);
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // (3, KC, COUT)
  float* slab = w_s + 3 * KC * COUT;             // (cb, rows, RS)
  int* src = reinterpret_cast<int*>(slab + cb * cs);  // (9, cb); -1: miss

  const int b = blockIdx.y;
  const int o0 = blockIdx.x * cb;
  const int tid = threadIdx.x;
  const int cl = tid % NL;
  const int v = tid / NL;
  const int col = v % cb;
  const int g = v / cb;
  const int o = o0 + col;
  const int z0 = g * kTM;
  const bool owner = g < zg && o < ocap;
  const long long orow = (long long)b * ocap + o;

  // the mask of the thread's output voxels, before any product
  bool m[kTM];
  bool any = false;
#pragma unroll
  for (int t = 0; t < kTM; ++t) m[t] = false;
  if (owner && valid[(long long)b * ocap + o0] && valid[orow]) {
    if (STRIDED) {
      for (int tap = 0; tap < 9; ++tap) {
        const int r = table[orow * 9 + tap];
        if (r < 0 || r >= vc) continue;
        const uint8_t* oc = occ + ((long long)b * vc + r) * z;
#pragma unroll
        for (int t = 0; t < kTM; ++t) {
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const int zi = 2 * (z0 + t) + dz - 1;
            if (zi >= 0 && zi < z && oc[zi]) m[t] = true;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kTM; ++t) m[t] = m[t] && z0 + t < zo;
    } else {  // the output columns are the input's: occ is the mask
      const uint8_t* oc = occ + orow * z;
#pragma unroll
      for (int t = 0; t < kTM; ++t) m[t] = z0 + t < zo && oc[z0 + t];
    }
#pragma unroll
    for (int t = 0; t < kTM; ++t) any = any || m[t];
  }
  const bool warp_on = __any_sync(kFull, any);
  const bool block_on = __syncthreads_or(any);

  float acc[kTM][kTN];
#pragma unroll
  for (int t = 0; t < kTM; ++t)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[t][n] = 0.f;

  if (block_on) {
    for (int i = tid; i < 9 * cb; i += kThreads) {
      const int tap = i / cb, c = i % cb;
      int r = -1;
      if (o0 + c < ocap) {
        const int k = table[((long long)b * ocap + o0 + c) * 9 + tap];
        if (k >= 0 && k < vc) r = b * vc + k;
      }
      src[i] = r;
    }
    // the thread's first staged row (input layer z0 - 1, or 2*z0 - 1);
    // a thread that owns no voxel reads column 0 and stores nothing
    const float* sa =
        slab + (g < zg ? col * cs + (STRIDED ? 2 * z0 : z0) * RS : 0);
    const float* sw = w_s + cl * 4;
    for (int tap = 0; tap < 9; ++tap) {
      for (int k0 = 0; k0 < CIN; k0 += KC) {
        __syncthreads();  // src is written; the last chunk's reads are done
        // rows (dz + 1)*9 + tap of the (27, CIN, COUT) weights, this chunk
        for (int i = tid; i < 3 * KC * COUT / 4; i += kThreads) {
          const int c4 = i % (COUT / 4);
          const int k = (i / (COUT / 4)) % KC;
          const int dz = i / (COUT / 4 * KC);
          reinterpret_cast<float4*>(w_s)[i] = __ldg(
              reinterpret_cast<const float4*>(
                  wts + ((long long)(dz * 9 + tap) * CIN + k0 + k) * COUT) +
              c4);
        }
        for (int i = tid; i < cb * rows * (KC / 4); i += kThreads) {
          const int c4 = i % (KC / 4);
          const int rr = (i / (KC / 4)) % rows;
          const int c = i / (KC / 4 * rows);
          const int r = src[tap * cb + c];
          const int zi = rr - 1;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r >= 0 && zi >= 0 && zi < z)
            x = __ldg(reinterpret_cast<const float4*>(
                          feats + ((long long)r * z + zi) * CIN + k0) +
                      c4);
          float* d = slab + c * cs + rr * RS + c4 * 4;
          d[0] = x.x;
          d[1] = x.y;
          d[2] = x.z;
          d[3] = x.w;
        }
        __syncthreads();
        if (!warp_on) continue;
#pragma unroll 2
        for (int k = 0; k < KC; ++k) {
          float a[S::kRows];
#pragma unroll
          for (int i = 0; i < S::kRows; ++i) a[i] = sa[i * RS + k];
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const float* wr = sw + (dz * KC + k) * COUT;
            const float4 w0 = *reinterpret_cast<const float4*>(wr);
            const float4 w1 = *reinterpret_cast<const float4*>(wr + COUT / 2);
#pragma unroll
            for (int t = 0; t < kTM; ++t) {
              const float x = a[STRIDED ? 2 * t + dz : t + dz];
              acc[t][0] = __fmaf_rn(x, w0.x, acc[t][0]);
              acc[t][1] = __fmaf_rn(x, w0.y, acc[t][1]);
              acc[t][2] = __fmaf_rn(x, w0.z, acc[t][2]);
              acc[t][3] = __fmaf_rn(x, w0.w, acc[t][3]);
              acc[t][4] = __fmaf_rn(x, w1.x, acc[t][4]);
              acc[t][5] = __fmaf_rn(x, w1.y, acc[t][5]);
              acc[t][6] = __fmaf_rn(x, w1.z, acc[t][6]);
              acc[t][7] = __fmaf_rn(x, w1.w, acc[t][7]);
            }
          }
        }
      }
    }
  }

  // LayerNorm over the voxel's COUT channels (its NL lanes), ReLU, mask
  const int c0 = cl * 4, c1 = COUT / 2 + cl * 4;
  float sc[kTN], sh[kTN];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    sc[n] = scale[c0 + n];
    sc[4 + n] = scale[c1 + n];
    sh[n] = shift[c0 + n];
    sh[4 + n] = shift[c1 + n];
  }
  constexpr float inv = 1.f / COUT;  // a power of two: exact
#pragma unroll
  for (int t = 0; t < kTM; ++t) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      s = __fadd_rn(s, acc[t][n]);
      q = __fadd_rn(q, __fmul_rn(acc[t][n], acc[t][n]));
    }
#pragma unroll
    for (int off = 1; off < NL; off <<= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
      q = __fadd_rn(q, __shfl_xor_sync(kFull, q, off));
    }
    const float mean = __fmul_rn(s, inv);
    const float var =
        fmaxf(__fsub_rn(__fmul_rn(q, inv), __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    float y[kTN];
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const float h = __fadd_rn(
          __fmul_rn(__fsub_rn(acc[t][n], mean), __fmul_rn(rstd, sc[n])),
          sh[n]);
      y[n] = m[t] ? fmaxf(h, 0.f) : 0.f;
    }
    if (owner && z0 + t < zo) {
      float* dst = out + (orow * zo + z0 + t) * COUT;
      *reinterpret_cast<float4*>(dst + c0) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(dst + c1) = make_float4(y[4], y[5], y[6], y[7]);
      if (STRIDED && cl == 0) out_occ[orow * zo + z0 + t] = m[t];
    }
  }
}

struct Args {
  const float* feats;
  const uint8_t* occ;
  const int* table;
  const float* wts;
  const float* scale;
  const float* shift;
  const uint8_t* valid;
  float* out;
  uint8_t* out_occ;
  int batch, vc, ocap, z, zo;
  float eps;
};

template <int CIN, int COUT, bool STRIDED>
int launch(const Args& a, cudaStream_t st) {
  using S = Shape<CIN, COUT, STRIDED>;
  const int zg = (a.zo + kTM - 1) / kTM;
  const int cb = S::kGroups / zg;
  if (cb < 1) return (int)cudaErrorInvalidValue;
  const int rows = slab_rows(zg, STRIDED);
  const long long smem =
      4LL * (3 * S::kChunk * COUT + (long long)cb * col_stride(rows, S::kRowStride) +
             9 * cb);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = column_conv_kernel<CIN, COUT, STRIDED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((a.ocap + cb - 1) / cb), (unsigned)a.batch);
  kernel<<<grid, kThreads, (size_t)smem, st>>>(
      a.feats, a.occ, a.table, a.wts, a.scale, a.shift, a.valid, a.out,
      a.out_occ, a.vc, a.ocap, a.z, a.zo, cb, zg, a.eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace heal

// The (Cin, Cout, strided) combinations of the published SECOND
// (channels 16/32/64/64 after the 4 point features); any other returns
// cudaErrorInvalidValue without a launch.
extern "C" int heal_column_conv_f32(const void* feats, const void* occ,
                                    const void* table, const void* wts,
                                    const void* scale, const void* shift,
                                    const void* valid, void* out,
                                    void* out_occ, int batch, int vc,
                                    int ocap, int z, int zo, int cin,
                                    int cout, int strided, float eps,
                                    void* stream) {
  using heal::launch;
  if (batch < 0 || vc <= 0 || ocap < 0 || z <= 0 || zo <= 0 ||
      (strided ? zo != (z - 1) / 2 + 1 : (zo != z || ocap != vc)) ||
      (strided && out_occ == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || ocap == 0) return (int)cudaGetLastError();
  const heal::Args a{static_cast<const float*>(feats),
                     static_cast<const uint8_t*>(occ),
                     static_cast<const int*>(table),
                     static_cast<const float*>(wts),
                     static_cast<const float*>(scale),
                     static_cast<const float*>(shift),
                     static_cast<const uint8_t*>(valid),
                     static_cast<float*>(out),
                     static_cast<uint8_t*>(out_occ),
                     batch, vc, ocap, z, zo, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (!strided) {
    if (cin == 4 && cout == 16) return launch<4, 16, false>(a, st);
    if (cin == 32 && cout == 32) return launch<32, 32, false>(a, st);
    if (cin == 64 && cout == 64) return launch<64, 64, false>(a, st);
  } else {
    if (cin == 16 && cout == 32) return launch<16, 32, true>(a, st);
    if (cin == 32 && cout == 64) return launch<32, 64, true>(a, st);
    if (cin == 64 && cout == 64) return launch<64, 64, true>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
