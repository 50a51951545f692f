// Fused photometric map, forward (kernel K2):
//   out[b,0,i,j] = mean over channels c of
//       alpha * clip((1 - SSIM(a,b))/2, 0, 1) + (1 - alpha) * |a - b|
// where SSIM uses 3x3 box means of a, b, a*a, b*b, a*b over a window that is
// reflect-padded by one pixel at the image border (-1 -> 1, H -> H-2).
//
// Replaces, in simpledepthestimation_tpu/ops/pallas_photometric.py, _kernel
// (via _pallas_forward, one whole plane per grid step) and _tiled_kernel (via
// _pallas_forward_tiled, row tiles with halo copies for planes that do not fit
// on chip), together with the channel mean taken after either. On this card a
// tile with a halo is the natural form at every size, so one kernel covers both.
//
// Bound on this card: bytes. The function must read a and b once and write one
// float per pixel: B*H*W*(2*s*C + 4) bytes for an s-byte input type, against
// ~70 flops per pixel and channel. The unfused composition writes and re-reads
// about a dozen full-size intermediates; this kernel keeps them in shared
// memory and registers.
// Design: one block per 16x64 output tile of one batch item. Per channel the
// block stages the 18x66 tile-plus-halo of a and of b in shared memory, with
// the reflection folded into the staging index, then each of its 256 threads
// forms the five window sums for four pixels of one column from shared memory
// and adds the channel's term to a register accumulator; the channel mean is
// written straight to the [B,1,H,W] output. Arithmetic is float32 for both
// input types. The halo costs 1188/1024 = 1.16x the tile's reads, served by L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

constexpr int kTileW = 64;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTileH * kTileW / kThreads;  // 4
constexpr int kRowStep = kThreads / kTileW;                 // 4

// reflect one pixel past either border; the clamp only serves tile positions
// that lie past the image's edge and are never written
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
photometric_map_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           float* __restrict__ out, int C, int H, int W,
                           float alpha, float C1, float C2) {
  __shared__ float sa[kTileH + 2][kTileW + 2];
  __shared__ float sb[kTileH + 2][kTileW + 2];

  const int bi = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const int lx = tid % kTileW, ly0 = tid / kTileW;
  const long long plane = (long long)H * W;

  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.0f;

  for (int c = 0; c < C; ++c) {
    const T* pa = a + ((long long)bi * C + c) * plane;
    const T* pb = b + ((long long)bi * C + c) * plane;
    for (int k = tid; k < (kTileH + 2) * (kTileW + 2); k += kThreads) {
      const int r = k / (kTileW + 2), q = k % (kTileW + 2);
      const int gy = reflect(ty0 + r - 1, H), gx = reflect(tx0 + q - 1, W);
      const long long off = (long long)gy * W + gx;
      sa[r][q] = ld(pa + off);
      sb[r][q] = ld(pb + off);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int ly = ly0 + j * kRowStep;
      float s_a = 0.f, s_b = 0.f, s_aa = 0.f, s_bb = 0.f, s_ab = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float va = sa[ly + dy][lx + dx], vb = sb[ly + dy][lx + dx];
          s_a += va;
          s_b += vb;
          s_aa += va * va;
          s_bb += vb * vb;
          s_ab += va * vb;
        }
      }
      const float mu_a = s_a / 9.0f, mu_b = s_b / 9.0f;
      const float sig_a = s_aa / 9.0f - mu_a * mu_a;
      const float sig_b = s_bb / 9.0f - mu_b * mu_b;
      const float sig_ab = s_ab / 9.0f - mu_a * mu_b;
      const float n = (2.0f * mu_a * mu_b + C1) * (2.0f * sig_ab + C2);
      const float d = (mu_a * mu_a + mu_b * mu_b + C1) * (sig_a + sig_b + C2);
      const float ssim_dist = fminf(fmaxf((1.0f - n / d) * 0.5f, 0.0f), 1.0f);
      const float l1 = fabsf(sa[ly + 1][lx + 1] - sb[ly + 1][lx + 1]);
      acc[j] += alpha * ssim_dist + (1.0f - alpha) * l1;
    }
    __syncthreads();
  }

  const int gx = tx0 + lx;
  if (gx < W) {
    const float inv_c = 1.0f / (float)C;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int gy = ty0 + ly0 + j * kRowStep;
      if (gy < H) out[(long long)bi * plane + (long long)gy * W + gx] = acc[j] * inv_c;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError() (0 = launched). Requires H >= 2 and W >= 2.
int sde_photometric_map_fwd(const void* a, const void* b, void* out, int B, int C, int H,
                            int W, float alpha, float C1, float C2, int is_bf16,
                            void* stream) {
  dim3 grid((unsigned)((W + kTileW - 1) / kTileW), (unsigned)((H + kTileH - 1) / kTileH),
            (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    photometric_map_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out, C, H, W, alpha, C1, C2);
  } else {
    photometric_map_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)b, (float*)out, C, H, W, alpha, C1, C2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
