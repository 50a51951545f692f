// Bilinear warp at float pixel coordinates x,y[b,i,j]: the forward sample
// (kernel K1), its coordinate cotangents (kernel K3) and its image cotangent
// (kernel K5).
//
// K1, forward: out[b,c,i,j] = sum over the four corners of
// image[b,c,y0+dy,x0+dx] * weight, every corner outside the image contributing
// zero (grid_sample's padding_mode="zeros", align_corners=True on unnormalised
// coordinates).
//
// Replaces, in simpledepthestimation_tpu/ops/pallas_warp.py, the three forward
// kernels that compute this one function: _tiled_fwd_kernel (via
// _call_tiled_fwd), _fwd_kernel (via _call_fwd) and _fwd_kernel_v2 (via
// _call_fwd_v2). Those express the gather as banded one-hot matrix products
// over row/column windows because their target has no vector gather; this card
// has one, so none of the window, flag or alignment machinery exists here.
//
// Bound on this card: bytes. Each output pixel reads 8 bytes of coordinates,
// and per channel reads about one image value (the four corners of neighbouring
// threads overlap and are served by L1/L2) and writes one: B*H*W*(8 + 2*s*C)
// bytes for an s-byte image type, against ~10 flops per channel.
// Design: one thread per output pixel, so the coordinate loads and the output
// stores are coalesced and the weights and masks are computed once for all
// channels; the gathers of one warp fall on a few neighbouring rows of the
// planar image wherever the warp field is smooth. Arithmetic is float32 for
// both image types. No shared memory, no synchronisation.
//
// K3, backward in the coordinates: with v00..v11 the four masked corner values
// of channel c and wx, wy the fractions,
//   dx[b,i,j] = sum_c ct[b,c,i,j] * ((v01 - v00)(1 - wy) + (v11 - v10) wy)
//   dy[b,i,j] = sum_c ct[b,c,i,j] * ((v10 - v00)(1 - wx) + (v11 - v01) wx)
// (floor has derivative zero). Replaces _tiled_bwd_kernel (via
// _call_tiled_bwd), _bwd_kernel (via _call_bwd_coords) and _bwd_kernel_v2 (via
// _call_bwd_coords_v2) of the same file, which fold both sums into one banded
// matrix product per tile. Bound: bytes, B*H*W*(8 + 8 + 2*s*C): coordinates in,
// two cotangent planes out, per channel one image value and one ct value.
// Design: K1's thread layout and K1's corner arithmetic (one shared routine, so
// forward and backward agree on every mask), the channel sum held in two
// registers: every output is written by exactly one thread, no atomics, so the
// result is deterministic. ct is read in the image's type and summed in float32.
//
// K5, backward in the image (coordinates held constant): the transpose of K1,
//   d_img[b,c,r,w] = sum over (i,j) and corners (r,w) of ct[b,c,i,j] * weight,
// with the corner weights (1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx*wy. Replaces
// _img_ct_kernel (via warp_image_cotangent) of the same file, which writes the
// scatter as a product of one-hot row and column matrices because its target
// has no scatter. Bound: bytes, B*Ho*Wo*(8 + s*C) read + B*Hi*Wi*C*4 written.
// Design: one thread per output pixel, K1's corners_at (so the three kernels
// agree on every clamp and mask), and per channel up to four float32
// atomicAdds into a zero-filled float32 d_img; corners outside the image or of
// weight exactly 0 are skipped. The atomics make the order of the additions,
// and so the last bits of d_img, vary from run to run. Where many pixels land
// on one address (coordinates clamped to the border) the atomics to that
// address serialise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kThreads = 256;

// The four corners of one output pixel: offsets into a plane (clamped, so
// always loadable), masks (false = outside the image, contributes zero) and
// the fractions. Shared by forward and backward.
struct Corners {
  long long o00, o01, o10, o11;
  bool m00, m01, m10, m11;
  float wx, wy;
};

__device__ __forceinline__ Corners corners_at(float xv, float yv, int Hi, int Wi) {
  Corners k;
  float x0f = floorf(xv), y0f = floorf(yv);
  k.wx = xv - x0f;
  k.wy = yv - y0f;
  // clamp while still float: a huge coordinate stays "outside" instead of
  // overflowing the int cast
  x0f = fminf(fmaxf(x0f, -2.0f), (float)Wi);
  y0f = fminf(fmaxf(y0f, -2.0f), (float)Hi);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = x0 + 1, y1 = y0 + 1;
  const bool inx0 = x0 >= 0 && x0 <= Wi - 1, inx1 = x1 >= 0 && x1 <= Wi - 1;
  const bool iny0 = y0 >= 0 && y0 <= Hi - 1, iny1 = y1 >= 0 && y1 <= Hi - 1;
  const int cx0 = min(max(x0, 0), Wi - 1), cx1 = min(max(x1, 0), Wi - 1);
  const int cy0 = min(max(y0, 0), Hi - 1), cy1 = min(max(y1, 0), Hi - 1);
  k.o00 = (long long)cy0 * Wi + cx0;
  k.o01 = (long long)cy0 * Wi + cx1;
  k.o10 = (long long)cy1 * Wi + cx0;
  k.o11 = (long long)cy1 * Wi + cx1;
  k.m00 = inx0 && iny0;
  k.m01 = inx1 && iny0;
  k.m10 = inx0 && iny1;
  k.m11 = inx1 && iny1;
  return k;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_fwd_kernel(const T* __restrict__ img, const float* __restrict__ x,
                         const float* __restrict__ y, T* __restrict__ out,
                         int C, int Hi, int Wi, long long out_plane) {
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= out_plane) return;
  const int b = blockIdx.y;
  const Corners k = corners_at(x[b * out_plane + pix], y[b * out_plane + pix], Hi, Wi);
  const float wx = k.wx, wy = k.wy;
  const long long in_plane = (long long)Hi * Wi;

  const T* src = img + (long long)b * C * in_plane;
  T* dst = out + (long long)b * C * out_plane + pix;
  for (int c = 0; c < C; ++c) {
    const float v00 = k.m00 ? ld(src + k.o00) : 0.0f;
    const float v01 = k.m01 ? ld(src + k.o01) : 0.0f;
    const float v10 = k.m10 ? ld(src + k.o10) : 0.0f;
    const float v11 = k.m11 ? ld(src + k.o11) : 0.0f;
    const float top = v00 * (1.0f - wx) + v01 * wx;
    const float bot = v10 * (1.0f - wx) + v11 * wx;
    st(dst, top * (1.0f - wy) + bot * wy);
    src += in_plane;
    dst += out_plane;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_bwd_coords_kernel(const T* __restrict__ img, const float* __restrict__ x,
                                const float* __restrict__ y, const T* __restrict__ ct,
                                float* __restrict__ dx, float* __restrict__ dy,
                                int C, int Hi, int Wi, long long out_plane) {
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= out_plane) return;
  const int b = blockIdx.y;
  const Corners k = corners_at(x[b * out_plane + pix], y[b * out_plane + pix], Hi, Wi);
  const float wx = k.wx, wy = k.wy;
  const long long in_plane = (long long)Hi * Wi;

  const T* src = img + (long long)b * C * in_plane;
  const T* g = ct + (long long)b * C * out_plane + pix;
  float ax = 0.0f, ay = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float v00 = k.m00 ? ld(src + k.o00) : 0.0f;
    const float v01 = k.m01 ? ld(src + k.o01) : 0.0f;
    const float v10 = k.m10 ? ld(src + k.o10) : 0.0f;
    const float v11 = k.m11 ? ld(src + k.o11) : 0.0f;
    const float gc = ld(g);
    ax += gc * ((v01 - v00) * (1.0f - wy) + (v11 - v10) * wy);
    ay += gc * ((v10 - v00) * (1.0f - wx) + (v11 - v01) * wx);
    src += in_plane;
    g += out_plane;
  }
  dx[b * out_plane + pix] = ax;
  dy[b * out_plane + pix] = ay;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_bwd_image_kernel(const T* __restrict__ ct, const float* __restrict__ x,
                               const float* __restrict__ y, float* __restrict__ d_img,
                               int C, int Hi, int Wi, long long out_plane) {
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= out_plane) return;
  const int b = blockIdx.y;
  const Corners k = corners_at(x[b * out_plane + pix], y[b * out_plane + pix], Hi, Wi);
  const float wx = k.wx, wy = k.wy;
  const float w00 = k.m00 ? (1.0f - wx) * (1.0f - wy) : 0.0f;
  const float w01 = k.m01 ? wx * (1.0f - wy) : 0.0f;
  const float w10 = k.m10 ? (1.0f - wx) * wy : 0.0f;
  const float w11 = k.m11 ? wx * wy : 0.0f;
  if (w00 == 0.0f && w01 == 0.0f && w10 == 0.0f && w11 == 0.0f) return;
  const long long in_plane = (long long)Hi * Wi;

  float* dst = d_img + (long long)b * C * in_plane;
  const T* g = ct + (long long)b * C * out_plane + pix;
  for (int c = 0; c < C; ++c) {
    const float gc = ld(g);
    if (gc != 0.0f) {
      if (w00 != 0.0f) atomicAdd(dst + k.o00, gc * w00);
      if (w01 != 0.0f) atomicAdd(dst + k.o01, gc * w01);
      if (w10 != 0.0f) atomicAdd(dst + k.o10, gc * w10);
      if (w11 != 0.0f) atomicAdd(dst + k.o11, gc * w11);
    }
    dst += in_plane;
    g += out_plane;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError() (0 = launched).
int sde_warp_bilinear_fwd(const void* img, const void* x, const void* y, void* out,
                          int B, int C, int Hi, int Wi, int Ho, int Wo,
                          int is_bf16, void* stream) {
  const long long out_plane = (long long)Ho * Wo;
  dim3 grid((unsigned)((out_plane + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_bilinear_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float*)x, (const float*)y,
        (__nv_bfloat16*)out, C, Hi, Wi, out_plane);
  } else {
    warp_bilinear_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)img, (const float*)x, (const float*)y, (float*)out, C, Hi, Wi,
        out_plane);
  }
  return (int)cudaGetLastError();
}

// Coordinate cotangents of the forward above; ct has the image's type, dx and
// dy are float32. Same launch contract.
int sde_warp_bilinear_bwd_coords(const void* img, const void* x, const void* y, const void* ct,
                                 void* dx, void* dy, int B, int C, int Hi, int Wi, int Ho,
                                 int Wo, int is_bf16, void* stream) {
  const long long out_plane = (long long)Ho * Wo;
  dim3 grid((unsigned)((out_plane + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_bilinear_bwd_coords_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float*)x, (const float*)y, (const __nv_bfloat16*)ct,
        (float*)dx, (float*)dy, C, Hi, Wi, out_plane);
  } else {
    warp_bilinear_bwd_coords_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)img, (const float*)x, (const float*)y, (const float*)ct, (float*)dx,
        (float*)dy, C, Hi, Wi, out_plane);
  }
  return (int)cudaGetLastError();
}

// Image cotangent of the forward above: d_img [B,C,Hi,Wi] float32, which the
// caller has zero-filled, accumulates ct [B,C,Ho,Wo] (the image's type) at
// coordinates x, y [B,Ho,Wo]. Same launch contract.
int sde_warp_bilinear_bwd_image(const void* ct, const void* x, const void* y, void* d_img,
                                int B, int C, int Hi, int Wi, int Ho, int Wo, int is_bf16,
                                void* stream) {
  const long long out_plane = (long long)Ho * Wo;
  dim3 grid((unsigned)((out_plane + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_bilinear_bwd_image_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)ct, (const float*)x, (const float*)y, (float*)d_img, C, Hi, Wi,
        out_plane);
  } else {
    warp_bilinear_bwd_image_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)ct, (const float*)x, (const float*)y, (float*)d_img, C, Hi, Wi, out_plane);
  }
  return (int)cudaGetLastError();
}

const char* sde_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
