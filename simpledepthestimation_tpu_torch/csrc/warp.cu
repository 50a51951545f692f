// Bilinear warp, forward (kernel K1): out[b,c,i,j] = sum over the four corners
// of image[b,c,y0+dy,x0+dx] * weight, at float pixel coordinates x,y[b,i,j],
// every corner outside the image contributing zero (grid_sample's
// padding_mode="zeros", align_corners=True on unnormalised coordinates).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_fwd_kernel(const T* __restrict__ img, const float* __restrict__ x,
                         const float* __restrict__ y, T* __restrict__ out,
                         int C, int Hi, int Wi, long long out_plane) {
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pix >= out_plane) return;
  const int b = blockIdx.y;
  const float xv = x[b * out_plane + pix];
  const float yv = y[b * out_plane + pix];

  float x0f = floorf(xv), y0f = floorf(yv);
  const float wx = xv - x0f, wy = yv - y0f;
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
  const long long in_plane = (long long)Hi * Wi;
  const long long o00 = (long long)cy0 * Wi + cx0, o01 = (long long)cy0 * Wi + cx1;
  const long long o10 = (long long)cy1 * Wi + cx0, o11 = (long long)cy1 * Wi + cx1;
  const bool m00 = inx0 && iny0, m01 = inx1 && iny0, m10 = inx0 && iny1, m11 = inx1 && iny1;

  const T* src = img + (long long)b * C * in_plane;
  T* dst = out + (long long)b * C * out_plane + pix;
  for (int c = 0; c < C; ++c) {
    const float v00 = m00 ? ld(src + o00) : 0.0f;
    const float v01 = m01 ? ld(src + o01) : 0.0f;
    const float v10 = m10 ? ld(src + o10) : 0.0f;
    const float v11 = m11 ? ld(src + o11) : 0.0f;
    const float top = v00 * (1.0f - wx) + v01 * wx;
    const float bot = v10 * (1.0f - wx) + v11 * wx;
    st(dst, top * (1.0f - wy) + bot * wy);
    src += in_plane;
    dst += out_plane;
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

const char* sde_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
