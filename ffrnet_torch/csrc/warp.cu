// Bilinear affine warps of face alignment, NHWC, fp32 or bf16 images.
//
// Replaces the two kernels of ffrnet_tpu/ops/pallas/warp.py:
//   warp_full_launch  <- warp_affine_pallas       every transform
//   warp_band_launch  <- warp_affine_pallas_band  column bands, bounded window
//
// Both invert the forward (src -> dst) matrices (N, 6) in fp32, as
// ops/kernels/warp.py::_invert_2x3 does (inside the kernel: the same 15
// tiny ops on the host side cost more than the warp), and sample each
// output pixel at the dst -> src coordinate
//     sx = i00*x + i01*y + i02,  sy = i10*x + i11*y + i12
// with 2x2 taps, tent weights max(1 - |tap - coord|, 0) and zero outside
// the source:
//     t(x) = wy0*p(y0, x) + wy1*p(y0+1, x)        per tap column
//     out  = wx0*t(x0) + wx1*t(x0+1)               per channel, fp32
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn), so
// nvcc contracts nothing into an FMA and the plain PyTorch twin, which
// rounds each elementwise op, agrees to the bit. A 1-ulp move of a
// coordinate near 200 px is 1.5e-5 px, up to 4e-3 on a noise image.
//
// Bound on the H100: bytes. At N=256, 250x250x3 fp32 -> 112x112 the source
// is 192 MB and the crops 38.5 MB (0.069 ms at 3.35 TB/s); the work is
// about 50 operations per output pixel. The warp reads only the pixels
// under the crop, about the face's share of each source.
//
// Design: the TPU kernels turned the warp into matmuls (an iota tent of
// y-weights times the image on the MXU, then a lane reduction against the
// x-weights) because the TPU gathers slowly. On the GPU a bilinear warp is
// a 4-tap gather: one thread per output pixel, its taps from global memory
// through L1/L2 (neighbouring output pixels read neighbouring taps).
//   full: one thread per output pixel, a grid of (pixel blocks, images).
//   band: one block per (image, band of band_w output columns). A block
//     reduction finds min sx over all out_h*band_w pixels of the band (the
//     columns past out_w in the last band included, as in the Pallas grid),
//     then x0 = clip(((floor(min) - 1) // 32) * 32, 0, wp - crop_w); taps
//     outside columns [x0, x0 + crop_w) read zero, so the kernel computes
//     what the Pallas kernel computes even where its contract fails. A bf16
//     image rounds the y-weights to bf16, as the Pallas kernel's MXU
//     operand did. The window is not staged in shared memory yet.
#include "common.cuh"

namespace {

using ffr::from_f;
using ffr::to_f;

constexpr int kThreads = 256;
constexpr int kQuant = 32;        // window start quantum, in columns
constexpr float kClamp = 1e9f;    // floor(min sx) is clamped before the int cast

struct Inverse {
  float i00, i01, i02, i10, i11, i12;
};

// The inverse of one forward matrix m = (a00 a01 a02 a10 a11 a12), every op
// rounded as the twin's elementwise PyTorch ops round it (IEEE division).
__device__ __forceinline__ Inverse invert(const float* __restrict__ m) {
  const float a00 = m[0], a01 = m[1], a02 = m[2], a10 = m[3], a11 = m[4], a12 = m[5];
  const float det = __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a10));
  Inverse r;
  r.i00 = __fdiv_rn(a11, det);
  r.i01 = __fdiv_rn(-a01, det);
  r.i10 = __fdiv_rn(-a10, det);
  r.i11 = __fdiv_rn(a00, det);
  r.i02 = -__fadd_rn(__fmul_rn(r.i00, a02), __fmul_rn(r.i01, a12));
  r.i12 = -__fadd_rn(__fmul_rn(r.i10, a02), __fmul_rn(r.i11, a12));
  return r;
}

__device__ __forceinline__ float coord(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float tent(float tap, float c) {
  return fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(tap, c))), 0.0f);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One output pixel: `img` is the sample's (h, w, c) source, `out` its c
// outputs. Taps outside rows [0, h) or columns [xlo, xhi) read zero.
template <typename T>
__device__ __forceinline__ void sample(const T* __restrict__ img, T* __restrict__ out, int h,
                                       int w, int c, float sx, float sy, int xlo, int xhi,
                                       bool bf16_weights) {
  if (!(sx > -1.0f && sx < (float)w && sy > -1.0f && sy < (float)h)) {
    for (int ch = 0; ch < c; ++ch) out[ch] = from_f<T>(0.0f);
    return;
  }
  const float x0f = floorf(sx), y0f = floorf(sy);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float wx0 = tent(x0f, sx), wx1 = tent(__fadd_rn(x0f, 1.0f), sx);
  float wy0 = tent(y0f, sy), wy1 = tent(__fadd_rn(y0f, 1.0f), sy);
  if (bf16_weights) {
    wy0 = round_bf16(wy0);
    wy1 = round_bf16(wy1);
  }
  const bool r0 = y0 >= 0, r1 = y0 + 1 < h;
  const bool c0 = x0 >= xlo && x0 < xhi, c1 = x0 + 1 >= xlo && x0 + 1 < xhi;
  const size_t row0 = (size_t)y0 * w, row1 = (size_t)(y0 + 1) * w;
  for (int ch = 0; ch < c; ++ch) {
    float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;
    if (r0 && c0) p00 = to_f(img[(row0 + x0) * c + ch]);
    if (r0 && c1) p01 = to_f(img[(row0 + x0 + 1) * c + ch]);
    if (r1 && c0) p10 = to_f(img[(row1 + x0) * c + ch]);
    if (r1 && c1) p11 = to_f(img[(row1 + x0 + 1) * c + ch]);
    if (bf16_weights) {  // pixels in bf16 too (a no-op for bf16 storage)
      p00 = round_bf16(p00);
      p01 = round_bf16(p01);
      p10 = round_bf16(p10);
      p11 = round_bf16(p11);
    }
    const float t0 = __fadd_rn(__fmul_rn(wy0, p00), __fmul_rn(wy1, p10));
    const float t1 = __fadd_rn(__fmul_rn(wy0, p01), __fmul_rn(wy1, p11));
    out[ch] = from_f<T>(__fadd_rn(__fmul_rn(wx0, t0), __fmul_rn(wx1, t1)));
  }
}

// grid: (pixel blocks of one image, images); blockIdx.y strides over the
// images past the grid's 65535 limit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_full_kernel(const T* __restrict__ img, const float* __restrict__ mats, T* __restrict__ out,
                 int n, int h, int w, int c, int out_h, int out_w, bool bf16_weights) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= out_h * out_w) return;
  const float x = (float)(p % out_w), y = (float)(p / out_w);
  for (int b = blockIdx.y; b < n; b += gridDim.y) {
    const Inverse v = invert(mats + (size_t)b * 6);
    const float sx = coord(v.i00, v.i01, v.i02, x, y);
    const float sy = coord(v.i10, v.i11, v.i12, x, y);
    sample<T>(img + (size_t)b * h * w * c, out + ((size_t)b * out_h * out_w + p) * c, h, w,
              c, sx, sy, 0, w, bf16_weights);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_band_kernel(const T* __restrict__ img, const float* __restrict__ mats, T* __restrict__ out,
                 int h, int w, int c, int out_h, int out_w, int band_w, int crop_w, int wp,
                 int n_bands) {
  __shared__ float warp_min[kThreads / 32];
  const int band = blockIdx.x % n_bands, b = blockIdx.x / n_bands;
  const int tp = out_h * band_w;
  const Inverse v = invert(mats + (size_t)b * 6);
  const float i00 = v.i00, i01 = v.i01, i02 = v.i02, i10 = v.i10, i11 = v.i11, i12 = v.i12;
  // 1. min sx over every pixel of the band
  float lo = __int_as_float(0x7f800000);  // +inf
  for (int p = threadIdx.x; p < tp; p += blockDim.x) {
    const float x = (float)(band * band_w + p % band_w), y = (float)(p / band_w);
    lo = fminf(lo, coord(i00, i01, i02, x, y));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = lo;
  __syncthreads();
  lo = warp_min[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) lo = fminf(lo, warp_min[k]);
  // 2. the window: clip to 0 before dividing (C++ '/' truncates toward 0)
  int x0 = (int)fminf(fmaxf(floorf(lo), -kClamp), kClamp) - 1;
  x0 = min((max(x0, 0) / kQuant) * kQuant, wp - crop_w);
  const int xhi = min(x0 + crop_w, w);
  // 3. the band's pixels that fall inside the output
  const T* src = img + (size_t)b * h * w * c;
  for (int p = threadIdx.x; p < tp; p += blockDim.x) {
    const int col = band * band_w + p % band_w, row = p / band_w;
    if (col >= out_w) continue;
    const float x = (float)col, y = (float)row;
    sample<T>(src, out + (((size_t)b * out_h + row) * out_w + col) * c, h, w, c,
              coord(i00, i01, i02, x, y), coord(i10, i11, i12, x, y), x0, xhi,
              sizeof(T) == 2);
  }
}

}  // namespace

// img: (N, H, W, C) contiguous, float (is_bf16 == 0) or bf16; mats: (N, 6)
// fp32 forward matrices; out: (N, out_h, out_w, C) of img's type.
// bf16_weights rounds the y-weights and the pixels to bf16.
extern "C" int warp_full_launch(const void* img, const void* mats, void* out, int n, int h,
                                int w, int c, int out_h, int out_w, int is_bf16,
                                int bf16_weights, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks((out_h * out_w + kThreads - 1) / kThreads, n < 65535 ? n : 65535);
  const float* m = static_cast<const float*>(mats);
  if (is_bf16)
    warp_full_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(img), m, static_cast<__nv_bfloat16*>(out), n, h, w,
        c, out_h, out_w, bf16_weights != 0);
  else
    warp_full_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(img), m, static_cast<float*>(out), n, h, w, c, out_h, out_w,
        bf16_weights != 0);
  return (int)cudaGetLastError();
}

// As warp_full_launch, per band of band_w output columns with a crop_w-wide
// source window (crop_w % 32 == 0, C <= 4, checked by the wrapper); wp is
// the padded source width max(W rounded up to 32, crop_w).
extern "C" int warp_band_launch(const void* img, const void* mats, void* out, int n, int h,
                                int w, int c, int out_h, int out_w, int band_w, int crop_w,
                                int wp, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_bands = (out_w + band_w - 1) / band_w;
  const int blocks = n * n_bands;  // one per (image, band)
  const float* m = static_cast<const float*>(mats);
  if (is_bf16)
    warp_band_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(img), m, static_cast<__nv_bfloat16*>(out), h, w, c,
        out_h, out_w, band_w, crop_w, wp, n_bands);
  else
    warp_band_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(img), m, static_cast<float*>(out), h, w, c, out_h, out_w,
        band_w, crop_w, wp, n_bands);
  return (int)cudaGetLastError();
}
