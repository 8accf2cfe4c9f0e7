// Per-row (or per-column) fractional shift with zero fill, for a batch of
// images in one launch: the building block of the 3-shear BEV warp
// (heal_tpu_torch/ops/warp.py affine_warp_shear).
//
// Replaces the TPU kernel heal_tpu/ops/pallas_shear.py `shift_rows_pallas`
// (`_shift_rows_impl`, Pallas body `_kernel`), forward only. The Pallas
// kernel pads every row by the largest shift, loads an 8-aligned window
// of it into VMEM and resolves the remainder with a static-slice switch,
// one image per call. Here one thread computes one output element of
// x (N, H, W, C): it reads its two source taps with bounds checks, so no
// padded copy is materialised, blends them in f32 and stores in the input
// type. Every agent of a pyramid level goes in one launch, with a shift
// per (image, row). axis=1 shifts columns instead (shift per (image,
// column), taps one row apart), which saves the two transposes that a
// column shift through a row kernel would cost.
//
// With s = shift, b = clamp(floor(s), -pad, pad), f = s - b and
// r = min(b, pad-1) (the clamps mirror heal_tpu.ops.warp._shift_rows,
// whose padded copy is pad wide and whose dynamic slice clamps its start;
// callers clip |s| <= pad - 2, where r = b):
//   axis 0: out[n, i, j, c] = (1-f)*x[n, i, j+r, c] + f*x[n, i, j+r+1, c]
//   axis 1: out[n, i, j, c] = (1-f)*x[n, i+r, j, c] + f*x[n, i+r+1, j, c]
// taps outside the image read zero. Any C works (65, 129, 257 on the
// pyramid path).
//
// Bound on the H100: bytes. Each element is read about twice (the second
// tap mostly hits L1/L2) and written once, at two flops. Neighbouring
// threads take neighbouring channels and columns, so loads and stores of
// a warp are contiguous.
#include <stdint.h>

#include "common.cuh"

namespace heal {

template <typename T>
__global__ void shift_rows_kernel(const T* __restrict__ x,
                                  const float* __restrict__ shifts,
                                  T* __restrict__ out, long long total,
                                  int h, int w, int c, int axis, int pad) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int ch = (int)(idx % c);
    long long t = idx / c;
    const int j = (int)(t % w);
    t /= w;
    const int i = (int)(t % h);
    const long long n = t / h;

    const float s = axis == 0 ? shifts[n * h + i] : shifts[n * w + j];
    const float b = fminf(fmaxf(floorf(s), (float)-pad), (float)pad);
    const float f = s - b;
    const int q0 = (axis == 0 ? j : i) + min((int)b, pad - 1);
    const int len = axis == 0 ? w : h;
    // element (n, i, j, ch) is at ((n*h + i)*w + j)*c + ch; a step of one
    // along the shifted axis is c (columns) or w*c (rows) elements
    const long long step_q = axis == 0 ? (long long)c : (long long)w * c;
    const long long base =
        axis == 0 ? ((n * h + i) * (long long)w) * c + ch
                  : (n * h * (long long)w + j) * c + ch;
    float v0 = 0.f, v1 = 0.f;
    if (q0 >= 0 && q0 < len) v0 = to_f32(x[base + q0 * step_q]);
    if (q0 + 1 >= 0 && q0 + 1 < len) v1 = to_f32(x[base + (q0 + 1) * step_q]);
    out[idx] = from_f32<T>(v0 * (1.f - f) + v1 * f);
  }
}

template <typename T>
int launch_shift_rows(const void* x, const void* shifts, void* out, int n,
                      int h, int w, int c, int axis, int pad, void* stream) {
  const long long total = (long long)n * h * w * c;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
    shift_rows_kernel<T><<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(shifts),
        static_cast<T*>(out), total, h, w, c, axis, pad);
  }
  return (int)cudaGetLastError();
}

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
