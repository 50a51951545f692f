// Fused photometric map: forward (kernel K2) and analytic VJP (kernel K4, in
// the second half of this file).
//
// K2, forward:
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

// ---------------------------------------------------------------------------
// K4, backward: the analytic VJP of the map above with respect to a and b.
// With g the cotangent of the [B,1,H,W] output scaled by 1/C, and per channel
// the window means mu_a, mu_b, the (co)variances sig_a, sig_b, sig_ab,
//   n1 = 2 mu_a mu_b + C1, n2 = 2 sig_ab + C2, d1 = mu_a^2 + mu_b^2 + C1,
//   d2 = sig_a + sig_b + C2, r = (1 - n1 n2 / (d1 d2)) / 2,
// the clip passes gradient where 0 < r < 1 (strictly). Per centre pixel q:
//   t = -alpha g[q] / 2 (0 outside the clip's range), d = d1 d2,
//   f_ab = 2 t n1 / d,  f_d2 = -t n1 n2 d1 / d^2,
//   f_mu_a = 2 mu_b t n2 / d - 2 mu_a t n1 n2 d2 / d^2 - 2 mu_a f_d2 - mu_b f_ab
// (f_mu_b is the mirror), and per pixel p
//   g_a[p] = PT(f_mu_a)[p] + 2 a[p] PT(f_d2)[p] + b[p] PT(f_ab)[p]
//            + (1 - alpha) g[p] sign(a[p] - b[p]),      sign(0) = 0,
//   g_b[p] = PT(f_mu_b)[p] + 2 b[p] PT(f_d2)[p] + a[p] PT(f_ab)[p] - (the L1 term).
// PT is the adjoint of the reflect-padded 3x3 mean, in gather form: pixel p
// collects the centres q within one pixel per axis, a centre counting twice
// where the reflection shows p to it a second time (per axis: p == 1 with
// q == 0, and p == n-2 with q == n-1), all divided by 9.
//
// Replaces _bwd_kernel (via _pallas_backward; math in _photo_vjp_plane and
// _pool9_adjoint_plane) of simpledepthestimation_tpu/ops/pallas_photometric.py,
// which holds a whole plane on chip per grid step and has no tiled form.
//
// Bound on this card: bytes. Read a, b and g once, write the wanted ones of
// g_a, g_b (float32) once: B*H*W*(2*s*C + 4 + 4*C*k) bytes, k = 1 or 2 outputs,
// against ~150 flops per pixel and channel. The unfused composition runs about
// forty full-size elementwise and pooling passes.
// Design: two stages in one launch, joined through shared memory. One block
// per 16x64 output tile of one batch item; per channel it (1) stages the 20x68
// tile of a and b with a halo of 2, reflection folded into the staging index;
// (2) computes the three or four f-fields on the 18x66 tile with a halo of 1
// (zero at centres outside the image, so they drop out of every sum), reading
// g from global memory once per centre; (3) gathers the weighted 3x3 sums of
// the fields for its four pixels per thread and writes the gradients. A null
// output pointer skips that gradient (and its field). Every output is written
// by one thread: no atomics, deterministic. One kernel serves every plane
// size, H, W >= 2. The halos cost 1360/1024 = 1.33x the tile's reads of a and
// b and 1.16x of g, served by L2.

namespace {

constexpr int kHalo2H = kTileH + 4, kHalo2W = kTileW + 4;  // a, b: halo of 2
constexpr int kHalo1H = kTileH + 2, kHalo1W = kTileW + 2;  // fields: halo of 1

// how often centre q sees pixel p in its reflect-padded window, along one axis
// of length n (for |p - q| <= 1, both inside the image)
__device__ __forceinline__ float multiplicity(int p, int q, int n) {
  return 1.0f + (float)(p == 1 && q == 0) + (float)(p == n - 2 && q == n - 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
photometric_map_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const float* __restrict__ g, float* __restrict__ g_a,
                           float* __restrict__ g_b, int C, int H, int W, float alpha,
                           float C1, float C2) {
  __shared__ float sa[kHalo2H][kHalo2W];
  __shared__ float sb[kHalo2H][kHalo2W];
  __shared__ float f_mu_a[kHalo1H][kHalo1W];
  __shared__ float f_mu_b[kHalo1H][kHalo1W];
  __shared__ float f_d2[kHalo1H][kHalo1W];
  __shared__ float f_ab[kHalo1H][kHalo1W];

  const int bi = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const int lx = tid % kTileW, ly0 = tid / kTileW;
  const long long plane = (long long)H * W;
  const float inv_c = 1.0f / (float)C;
  const float* gp = g + (long long)bi * plane;
  const bool want_a = g_a != nullptr, want_b = g_b != nullptr;

  // per-thread constants of the gather: column weights, and the cotangent at
  // the thread's own pixels for the L1 term
  const int gx = tx0 + lx;
  float wcol[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) wcol[i] = multiplicity(gx, gx + i - 1, W);
  float g_own[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int gy = ty0 + ly0 + j * kRowStep;
    g_own[j] = (gx < W && gy < H) ? gp[(long long)gy * W + gx] * inv_c : 0.0f;
  }

  for (int c = 0; c < C; ++c) {
    const long long chan = ((long long)bi * C + c) * plane;
    const T* pa = a + chan;
    const T* pb = b + chan;
    for (int k = tid; k < kHalo2H * kHalo2W; k += kThreads) {
      const int r = k / kHalo2W, q = k % kHalo2W;
      const int sy = reflect(ty0 + r - 2, H), sx = reflect(tx0 + q - 2, W);
      const long long off = (long long)sy * W + sx;
      sa[r][q] = ld(pa + off);
      sb[r][q] = ld(pb + off);
    }
    __syncthreads();

    for (int k = tid; k < kHalo1H * kHalo1W; k += kThreads) {
      const int r = k / kHalo1W, q = k % kHalo1W;
      const int cy = ty0 + r - 1, cx = tx0 + q - 1;
      float o_mu_a = 0.f, o_mu_b = 0.f, o_d2 = 0.f, o_ab = 0.f;
      if (cy >= 0 && cy < H && cx >= 0 && cx < W) {
        float s_a = 0.f, s_b = 0.f, s_aa = 0.f, s_bb = 0.f, s_ab = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float va = sa[r + dy][q + dx], vb = sb[r + dy][q + dx];
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
        const float n1 = 2.0f * mu_a * mu_b + C1, n2 = 2.0f * sig_ab + C2;
        const float d1 = mu_a * mu_a + mu_b * mu_b + C1, d2 = sig_a + sig_b + C2;
        const float n = n1 * n2, d = d1 * d2;
        const float ratio = (1.0f - n / d) * 0.5f;
        if (ratio > 0.0f && ratio < 1.0f) {
          const float g_ratio = -0.5f * alpha * gp[(long long)cy * W + cx] * inv_c;
          const float g_n = g_ratio / d;
          const float g_d = -g_ratio * n / (d * d);
          const float g_n1 = g_n * n2, g_n2 = g_n * n1;
          const float g_d1 = g_d * d2, g_d2 = g_d * d1;
          o_ab = 2.0f * g_n2;
          o_d2 = g_d2;
          o_mu_a = 2.0f * mu_b * g_n1 + 2.0f * mu_a * g_d1 - 2.0f * mu_a * g_d2 - mu_b * o_ab;
          o_mu_b = 2.0f * mu_a * g_n1 + 2.0f * mu_b * g_d1 - 2.0f * mu_b * g_d2 - mu_a * o_ab;
        }
      }
      f_mu_a[r][q] = o_mu_a;
      f_mu_b[r][q] = o_mu_b;
      f_d2[r][q] = o_d2;
      f_ab[r][q] = o_ab;
    }
    __syncthreads();

    if (gx < W) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int ly = ly0 + j * kRowStep;
        const int gy = ty0 + ly;
        if (gy >= H) continue;
        float t_mu_a = 0.f, t_mu_b = 0.f, t_d2 = 0.f, t_ab = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float wrow = multiplicity(gy, gy + dy - 1, H);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float w = wrow * wcol[dx];
            t_mu_a += w * f_mu_a[ly + dy][lx + dx];
            t_mu_b += w * f_mu_b[ly + dy][lx + dx];
            t_d2 += w * f_d2[ly + dy][lx + dx];
            t_ab += w * f_ab[ly + dy][lx + dx];
          }
        }
        const float va = sa[ly + 2][lx + 2], vb = sb[ly + 2][lx + 2];
        const float diff = va - vb;
        const float sgn = (float)(diff > 0.0f) - (float)(diff < 0.0f);
        const float l1 = (1.0f - alpha) * g_own[j] * sgn;
        const long long off = chan + (long long)gy * W + gx;
        if (want_a) g_a[off] = (t_mu_a + 2.0f * va * t_d2 + vb * t_ab) / 9.0f + l1;
        if (want_b) g_b[off] = (t_mu_b + 2.0f * vb * t_d2 + va * t_ab) / 9.0f - l1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// g is float32 [B,1,H,W]; g_a and g_b are float32 [B,C,H,W], either may be
// null (that gradient is skipped). Same launch contract as the forward.
int sde_photometric_map_bwd(const void* a, const void* b, const void* g, void* g_a, void* g_b,
                            int B, int C, int H, int W, float alpha, float C1, float C2,
                            int is_bf16, void* stream) {
  dim3 grid((unsigned)((W + kTileW - 1) / kTileW), (unsigned)((H + kTileH - 1) / kTileH),
            (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    photometric_map_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (const float*)g, (float*)g_a,
        (float*)g_b, C, H, W, alpha, C1, C2);
  } else {
    photometric_map_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)b, (const float*)g, (float*)g_a, (float*)g_b, C, H, W,
        alpha, C1, C2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
