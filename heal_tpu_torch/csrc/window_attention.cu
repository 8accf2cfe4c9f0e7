// Kernel 4: the attention core of one V2X-ViT MSwin branch
// (models/fuse/v2xvit.py WindowAttention) in one launch: softmax(q k^T /
// sqrt(dh) + relative-position bias) v inside every non-overlapping
// window x window tile of the map, for every head, in f32
// (heal_tpu_torch/ops/window_attention.py window_attention; its plain
// version window_attention_plain partitions the map into windows, gathers
// the (heads, T, T) bias through the offset index, runs
// models/layers.dot_product_attention and merges the windows back).
//
// Replaces no TPU kernel: JAX's MSwin (heal_tpu/models/fuse/v2xvit.py)
// is flax's MultiHeadDotProductAttention, XLA ops. The plain version
// copies the map into windows, gathers the bias, scales q, writes the
// (windows, heads, T, T) logits to device memory, adds the bias, runs a
// separate softmax and a batched product, and copies the windows back:
// for the 16 x 16 windows of V2X-ViT's published block the logits alone
// are 0.67 GB a layer on the v2xvit.serve map (5 x 128 x 256 tokens).
//
// Input: qkv (N, H, W, 3, heads, dh), the fused q / k / v projection of
// every token as the wrapper makes it (one product), read in place
// through its strides; the table ((2 ws - 1)^2, heads); output (N, H, W,
// heads * dh), token-major, so the out projection is a plain product over
// tokens. H and W are multiples of the window (MSwin pads).
//
// Bound on the H100. With q, k and v read once and the output written
// once, a branch moves 16 * N * heads * dh bytes; its products are 4 * N *
// T * heads * dh f32 operations (T = ws^2 tokens a window). On the cell's
// map (N = 163,840 tokens, heads * dh = 256) that is 671 MB (0.200 ms at
// 3.35 TB/s) against 42.9 / 10.7 / 2.7 GFLOP (0.641 / 0.160 / 0.040 ms at
// 67 TFLOP/s) for windows 16 / 8 / 4: window 16 is bound by operations,
// windows 8 and 4 (and 2) by bytes. Tensor cores are not used: the
// configuration states f32 with TF32 off. Design:
//   * A unit is one (slot, window, head). A thread owns kR = 4 query rows
//     and a kDS = 8 wide slice of the head width, so each 16-byte load of
//     a key or value row from shared memory feeds 16 FMAs (shared-memory
//     loads, not FMAs, set the pace of a SIMT attention); the kG = dh / 8
//     lanes of a row are neighbours in the warp and hold interleaved
//     16-byte chunks, so a unit's lanes read one contiguous run of a key
//     row (the other rows' lanes read the same address). A block takes
//     kUnits consecutive units, heads fastest, at least 128 threads: one
//     (window, head) of 256 tokens and 512 threads for window 16 at dh 64
//     (the operation-bound branch); several windows' heads for the
//     byte-bound ones (16 units of window 4, 2 of window 8; four such
//     blocks an SM overlap one's copies with another's products), so that
//     a block stages tens of KB with 16-byte cp.async copies, the tokens'
//     head slices contiguous.
//   * Prologue: the block copies its units' K and V (T x dh each; 64 KB
//     each at window 16, dh 64) into shared memory with cp.async, and
//     each unit's head column of the table ((2 ws - 1)^2 floats). A
//     logit's bias index is computed from the two tokens' (dy, dx)
//     offset: no index tensor and no (heads, T, T) bias in device memory.
//   * Each thread loads its rows of q from the projection, scaled by the
//     f32 reciprocal of sqrt(dh) as the plain path scales them on the
//     card. Keys go in blocks of kKB: the block's logits are a register
//     tile (kR x kKB) of partial dot products over the lane's slice. The
//     row's kG lanes sum them by shuffles that also split them (each lane
//     finishes kR / kG rows, or half a row's keys at kG = 8, in a
//     lane-relative order of rows and keys that keeps every register
//     index fixed), so the bias, the online softmax (running max and sum,
//     expf, f32) and its exponentials are done once a logit, not once a
//     lane; the probabilities go back to every lane by shuffles, and P.V
//     is accumulated in registers. The logits never reach device memory;
//     one store of each output row, divided by the row's sum.
//   * Arithmetic: f32 FMAs written as __fmaf_rn (the build has
//     --fmad=false, under which a * b + c would be a separate multiply and
//     add). The results equal the plain path's up to the order of the f32
//     sums and the softmax's normalisation, applied once at the end.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace heal {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLR = 2;            // log2 of the query rows a thread owns
constexpr int kR = 1 << kLR;
constexpr int kDS = 8;            // head dims a thread owns
constexpr int kNC = kDS / 4;      // a thread's float4 chunks
constexpr int kMinThreads = 128;  // threads of a block, at least
constexpr int kSmThreads = 512;   // threads an SM holds (128 registers)

constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

template <int WS, int DH>
struct Tile {
  static constexpr int kT = WS * WS;              // tokens of a window
  static constexpr int kG = DH / kDS;             // lanes sharing a row
  // keys a softmax step (4 at dh 8, where a lane's logits are all four
  // rows', so that they fit in registers)
  static constexpr int kKB = kT < 8 ? kT : (kG == 1 ? 4 : 8);
  // the lanes of a row split the block's logits: their top lane bits
  // (at most kLR) split the rows, a remaining one the keys
  static constexpr int kRowBits = log2i(kG) < kLR ? log2i(kG) : kLR;
  static constexpr int kKeyBits = log2i(kG) - kRowBits;
  static constexpr int kUnitThreads = kT / kR * kG;
  static constexpr int kThreads =
      kUnitThreads > kMinThreads ? kUnitThreads : kMinThreads;
  static constexpr int kUnits = kThreads / kUnitThreads;
  static constexpr int kSpan = 2 * WS - 1;
  static constexpr int kTable = kSpan * kSpan;
  // one unit's K (or V) in shared memory; the 16-byte pad puts the units
  // a warp spans in distinct banks
  static constexpr int kKV = kT * DH + 4;
  static constexpr int kSmemFloats = 2 * kUnits * kKV + kUnits * kTable;
  static_assert(kT % kR == 0 && kT % kKB == 0 && DH % kDS == 0 &&
                    (1 << log2i(kG)) == kG && kKeyBits <= 1 &&
                    32 % kG == 0 &&
                    kThreads % kUnitThreads == 0 &&
                    (kUnitThreads % 32 == 0 || 32 % kUnitThreads == 0),
                "unsupported window or head width");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(__fmaf_rn(a, b.x, c.x), __fmaf_rn(a, b.y, c.y),
                     __fmaf_rn(a, b.z, c.z), __fmaf_rn(a, b.w, c.w));
}

template <int WS, int DH>
__global__ void __launch_bounds__(Tile<WS, DH>::kThreads,
                                  kSmThreads / Tile<WS, DH>::kThreads)
    window_attention_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ table,
                            float* __restrict__ out, long long units, int h,
                            int w, int heads, int nwy, int nwx,
                            float scale) {
  using S = Tile<WS, DH>;
  constexpr int T = S::kT, G = S::kG, NC = kNC, KB = S::kKB;
  constexpr int RB = S::kRowBits, KBITS = S::kKeyBits;
  constexpr int kChunks = T * DH / 4;  // float4 of one unit's K (or V)
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (kUnits, kKV)
  float* vs = ks + S::kUnits * S::kKV;          // (kUnits, kKV)
  float* tb = vs + S::kUnits * S::kKV;          // (kUnits, kTable)
  __shared__ long long first_tok[S::kUnits];    // -1: past the last unit
  __shared__ int head_of[S::kUnits];

  const int tid = threadIdx.x;
  const long long u0 = (long long)blockIdx.x * S::kUnits;
  const long long tok_stride = 3LL * heads * DH;  // floats between tokens
  const int part = heads * DH;                    // q -> k -> v

  if (tid < S::kUnits) {
    const long long u = u0 + tid;
    long long first = -1;
    int hd = 0;
    if (u < units) {
      hd = (int)(u % heads);
      const long long win = u / heads;
      const int wx = (int)(win % nwx);
      const long long rest = win / nwx;
      const int wy = (int)(rest % nwy);
      const long long n = rest / nwy;
      first = (n * h + (long long)wy * WS) * w + (long long)wx * WS;
    }
    first_tok[tid] = first;
    head_of[tid] = hd;
  }
  __syncthreads();

  // prologue: the units' K and V, and their heads' bias columns
  for (int e = tid; e < S::kUnits * kChunks; e += S::kThreads) {
    const int ul = e / kChunks, r = e % kChunks;
    const long long first = first_tok[ul];
    if (first < 0) continue;
    const int j = r / (DH / 4), c = r % (DH / 4);
    const long long tok = first + (long long)(j / WS) * w + (j % WS);
    const float* src =
        qkv + tok * tok_stride + part + head_of[ul] * DH + 4 * c;
    float* dst = ks + ul * S::kKV + j * DH + 4 * c;
    cp_async16(dst, src);
    cp_async16(dst + S::kUnits * S::kKV, src + part);
  }
  for (int e = tid; e < S::kUnits * S::kTable; e += S::kThreads) {
    const int ul = e / S::kTable, t = e % S::kTable;
    tb[e] = first_tok[ul] < 0 ? 0.f
                              : table[(long long)t * heads + head_of[ul]];
  }

  // the thread's unit, rows and slice. A lane works in its own frame:
  // local row rl is the unit's row p + (rl ^ rx) * T / kR and local key jl
  // of a block is key jl ^ kx, so that the lanes of a row split the
  // block's logits between them with fixed register indices (below)
  const int ul = tid / S::kUnitThreads;
  const int ut = tid % S::kUnitThreads;
  const int p = ut / G, g = ut % G;
  const int rx = ((g >> KBITS) & ((1 << RB) - 1)) << (kLR - RB);
  const int kx = KBITS ? (g & 1) * (KB / 2) : 0;
  const long long first = first_tok[ul];
  const bool live = first >= 0;
  const int hd = head_of[ul];
  const float* ku = ks + ul * S::kKV + 4 * g;
  const float* vu = vs + ul * S::kKV + 4 * g;
  const float* tu = tb + ul * S::kTable;
  float4 q[kR][NC], o[kR][NC];
  float m[kR], l[kR];
  int brow[kR];  // the row's part of a bias index
#pragma unroll
  for (int rl = 0; rl < kR; ++rl) {
    const int i = p + (rl ^ rx) * (T / kR);
    const int yi = i / WS, xi = i % WS;
    const long long tok = first + (long long)yi * w + xi;
    brow[rl] = (WS - 1 - yi) * S::kSpan + (WS - 1 - xi);
    m[rl] = -INFINITY;
    l[rl] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live)
        v = __ldg(reinterpret_cast<const float4*>(
            qkv + tok * tok_stride + hd * DH + 4 * (c * G + g)));
      q[rl][c] = make_float4(v.x * scale, v.y * scale, v.z * scale,
                             v.w * scale);
      o[rl][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the logits a lane finishes after the split: NR local rows, NK keys
  constexpr int NR = kR >> RB;
  constexpr int NK = KB >> KBITS;
  for (int j0 = 0; j0 < T; j0 += KB) {
    // the block's logits: partial dot products over the lane's slice
    float s[kR][KB];
#pragma unroll
    for (int jl = 0; jl < KB; ++jl) {
      const float* kr = ku + (j0 + (jl ^ kx)) * DH;
#pragma unroll
      for (int rl = 0; rl < kR; ++rl) s[rl][jl] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * G * c);
#pragma unroll
        for (int rl = 0; rl < kR; ++rl) {
          s[rl][jl] = __fmaf_rn(q[rl][c].x, kv.x, s[rl][jl]);
          s[rl][jl] = __fmaf_rn(q[rl][c].y, kv.y, s[rl][jl]);
          s[rl][jl] = __fmaf_rn(q[rl][c].z, kv.z, s[rl][jl]);
          s[rl][jl] = __fmaf_rn(q[rl][c].w, kv.w, s[rl][jl]);
        }
      }
    }
    // summed over the row's lanes and split between them: across each row
    // bit the partner holds this lane's upper local rows as its lower
    // ones, across the key bit this lane's keys NK.. as its keys 0..
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int half = kR >> (b + 1);
      const int off = 1 << (KBITS + RB - 1 - b);
#pragma unroll
      for (int rl = 0; rl < half; ++rl) {
#pragma unroll
        for (int jl = 0; jl < KB; ++jl)
          s[rl][jl] += __shfl_xor_sync(kFull, s[rl + half][jl], off);
      }
    }
    if constexpr (KBITS == 1) {
#pragma unroll
      for (int rl = 0; rl < NR; ++rl) {
#pragma unroll
        for (int jl = 0; jl < NK; ++jl)
          s[rl][jl] += __shfl_xor_sync(kFull, s[rl][jl + NK], 1);
      }
    }
    // plus the bias of the (dy, dx) offset: index
    // (yj - yi + ws - 1) * span + (xj - xi + ws - 1); the block's max of
    // each row the lane finishes, then of every local row
    float mb[kR];
#pragma unroll
    for (int rl = 0; rl < NR; ++rl) {
#pragma unroll
      for (int jl = 0; jl < NK; ++jl) {
        const int j = j0 + (jl ^ kx);
        s[rl][jl] += tu[brow[rl] + (j / WS) * S::kSpan + (j % WS)];
      }
      mb[rl] = s[rl][0];
#pragma unroll
      for (int jl = 1; jl < NK; ++jl) mb[rl] = fmaxf(mb[rl], s[rl][jl]);
      if constexpr (KBITS == 1)
        mb[rl] = fmaxf(mb[rl], __shfl_xor_sync(kFull, mb[rl], 1));
    }
#pragma unroll
    for (int b = RB - 1; b >= 0; --b) {
      const int half = kR >> (b + 1);
      const int off = 1 << (KBITS + RB - 1 - b);
#pragma unroll
      for (int rl = 0; rl < half; ++rl)
        mb[rl + half] = __shfl_xor_sync(kFull, mb[rl], off);
    }
    // online softmax: rescale the running sums and outputs to the new max
#pragma unroll
    for (int rl = 0; rl < kR; ++rl) {
      const float mn = fmaxf(m[rl], mb[rl]);
      const float alpha = expf(m[rl] - mn);  // 0 at the first block
      m[rl] = mn;
      l[rl] *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        o[rl][c] = make_float4(o[rl][c].x * alpha, o[rl][c].y * alpha,
                               o[rl][c].z * alpha, o[rl][c].w * alpha);
    }
#pragma unroll
    for (int rl = 0; rl < NR; ++rl) {
#pragma unroll
      for (int jl = 0; jl < NK; ++jl) {
        s[rl][jl] = expf(s[rl][jl] - m[rl]);
        l[rl] += s[rl][jl];  // the lane's share of its row's sum
      }
    }
    // every lane takes the block's probabilities back, in its own frame
    if constexpr (KBITS == 1) {
#pragma unroll
      for (int rl = 0; rl < NR; ++rl) {
#pragma unroll
        for (int jl = 0; jl < NK; ++jl)
          s[rl][jl + NK] = __shfl_xor_sync(kFull, s[rl][jl], 1);
      }
    }
#pragma unroll
    for (int b = RB - 1; b >= 0; --b) {
      const int half = kR >> (b + 1);
      const int off = 1 << (KBITS + RB - 1 - b);
#pragma unroll
      for (int rl = 0; rl < half; ++rl) {
#pragma unroll
        for (int jl = 0; jl < KB; ++jl)
          s[rl + half][jl] = __shfl_xor_sync(kFull, s[rl][jl], off);
      }
    }
    // P.V over the block's keys
#pragma unroll
    for (int jl = 0; jl < KB; ++jl) {
      const float* vr = vu + (j0 + (jl ^ kx)) * DH;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * G * c);
#pragma unroll
        for (int rl = 0; rl < kR; ++rl)
          o[rl][c] = fma4(s[rl][jl], vv, o[rl][c]);
      }
    }
  }

  // each row's sum from its lanes' shares
#pragma unroll
  for (int rl = 0; rl < NR; ++rl) {
    if constexpr (KBITS == 1) l[rl] += __shfl_xor_sync(kFull, l[rl], 1);
  }
#pragma unroll
  for (int b = RB - 1; b >= 0; --b) {
    const int half = kR >> (b + 1);
    const int off = 1 << (KBITS + RB - 1 - b);
#pragma unroll
    for (int rl = 0; rl < half; ++rl)
      l[rl + half] = __shfl_xor_sync(kFull, l[rl], off);
  }
  if (!live) return;
#pragma unroll
  for (int rl = 0; rl < kR; ++rl) {
    const int i = p + (rl ^ rx) * (T / kR);
    const long long tok = first + (long long)(i / WS) * w + (i % WS);
    float* dst = out + tok * part + hd * DH + 4 * g;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(dst + 4 * G * c) =
          make_float4(o[rl][c].x / l[rl], o[rl][c].y / l[rl],
                      o[rl][c].z / l[rl], o[rl][c].w / l[rl]);
  }
}

template <int WS, int DH>
int launch(const float* qkv, const float* table, float* out, int n, int h,
           int w, int heads, float scale, cudaStream_t st) {
  using S = Tile<WS, DH>;
  const int nwy = h / WS, nwx = w / WS;
  const long long units = (long long)n * nwy * nwx * heads;
  const long long blocks = (units + S::kUnits - 1) / S::kUnits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * S::kSmemFloats;
  auto kernel = window_attention_kernel<WS, DH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, S::kThreads, (size_t)smem, st>>>(
      qkv, table, out, units, h, w, heads, nwy, nwx, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace heal

// Windows 2, 4 and 8 at head widths 8, 16, 32 and 64, window 16 at 64:
// V2X-ViT's published block (windows 4 / 8 / 16 with 16 x 16, 8 x 32,
// 4 x 64 heads) and the flat form (windows 2 / 4 / 8, 8 heads of C / 8 at
// C = 64 to 512); any other window, width or a map that is not a whole
// number of windows returns cudaErrorInvalidValue without a launch.
extern "C" int heal_window_attention_f32(const void* qkv, const void* table,
                                         void* out, int n, int h, int w,
                                         int heads, int window, int dh,
                                         float scale, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || heads <= 0 || window <= 0 ||
      h % window || w % window)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const float* q = static_cast<const float*>(qkv);
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
#define HEAL_WINDOW_CASE(WS, DH)                                    \
  if (window == WS && dh == DH)                                     \
    return heal::launch<WS, DH>(q, t, o, n, h, w, heads, scale, st);
#define HEAL_WINDOW_CASES(WS) \
  HEAL_WINDOW_CASE(WS, 8)     \
  HEAL_WINDOW_CASE(WS, 16)    \
  HEAL_WINDOW_CASE(WS, 32)    \
  HEAL_WINDOW_CASE(WS, 64)
  HEAL_WINDOW_CASES(2)
  HEAL_WINDOW_CASES(4)
  HEAL_WINDOW_CASES(8)
  HEAL_WINDOW_CASE(16, 64)
#undef HEAL_WINDOW_CASES
#undef HEAL_WINDOW_CASE
  return (int)cudaErrorInvalidValue;
}
