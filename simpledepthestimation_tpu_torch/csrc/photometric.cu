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
// float per pixel: B*H*W*(2*s*C + 4) bytes for an s-byte input type (0.0329 ms
// at [32,3,192,640] float32 at 3.35 TB/s); its ~70 flops per pixel and channel
// are far below the float32 rate's balance. The unfused composition writes and
// re-reads about a dozen full-size intermediates; this kernel keeps them in
// shared memory and registers.
// Design:
// - One block of 256 threads per 32x64 output tile of one batch item (16x64,
//   ROWS = 4, where the grid of 32-row tiles would not fill the card once at 4
//   blocks per SM: twice the blocks for the small planes). Each thread owns one
//   column and walks ROWS consecutive rows of it; the three staged rows of a
//   window are held in registers as the walk goes down (6 shared loads per
//   pixel and channel; the loop unrolled, so the ring needs no copies).
// - The window sums are taken in the plain version's order (avg_pool2d's:
//   row-major, one term at a time, each product rounded first) and divided by 9
//   correctly rounded, so they are the plain version's to the bit: separable row
//   and column sums (4 adds a sum, not 8) measured 0.0544 ms but moved the map
//   by up to 1.3e-5 against the plain version at C = 2 (the variances cancel,
//   E[a^2] - mu^2 with both near 0.3, and are divided by d2 down to C2), past
//   the 1e-5 it is held to; not shipped.
// - The tile plus its one-pixel halo (34x66) is staged per channel. The
//   reflection is computed once per row and once per column of the tile (two
//   small tables), and each thread's staging offsets once per block, for all
//   channels and both inputs. float32 is copied with cp.async, double-buffered
//   over the channel loop: channel c+1's tile is in flight while channel c is
//   summed. bfloat16 (cp.async moves 4 bytes at least) is loaded into registers
//   before channel c is summed and stored, as float32, after it. The halo costs
//   2244/2048 = 1.10x the tile's reads, served by L2.
// - One approximate reciprocal of d (d >= C1*C2 > 0), the ratio taken as
//   (d - n)*(1/d)*0.5, and n1, n2, d1, d2 rounded one operation at a time as the
//   plain version rounds them: a == b gives n == d and a map of exactly 0, as the
//   plain version does, whatever nvcc contracts. (A kernel that left n and d to
//   contraction gave non-zero values at a == b at more than half the pixels.)
// - Arithmetic is float32 for both input types; the channel mean is written
//   straight to the [B,1,H,W] output.
// Resources (ptxas -v, sm_90a): 64 registers, 36,304 B of shared memory at
// ROWS = 8 (61 and 19,344 B at ROWS = 4), no spills in float32 (80 B at
// bfloat16, ROWS = 8): 4 blocks (32 warps) per SM. The SASS holds ~150
// instructions per pixel and channel, 40 of them the window's sequential adds,
// so the instruction count, not the bytes, sets the time (PERF.md).

#include "common.cuh"

namespace {

using sde::ld;

constexpr int kThreads = 256;
constexpr float kNinth = 1.0f / 9.0f;

// reflect one pixel past either border; the clamp only serves tile positions
// that lie past the image's edge and are never written
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// One staged element: asynchronously for float32 (wait before the barrier that
// follows) and with a plain load for bfloat16 (cp.async moves 4 bytes at least).
__device__ __forceinline__ void copy4(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy4(float* dst, const __nv_bfloat16* src) { *dst = ld(src); }

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// all but the most recently committed group have landed
__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// One staged row at a centre column: the three values of a and of b.
struct Row3 {
  float a0, a1, a2, b0, b1, b2;
};

__device__ __forceinline__ Row3 load_row(const float* sa, const float* sb, int at) {
  return {sa[at], sa[at + 1], sa[at + 2], sb[at], sb[at + 1], sb[at + 2]};
}

// The five window sums of a, b, a*a, b*b, a*b, taken in the plain version's
// order (avg_pool2d's: row-major, one term at a time, each product rounded
// before it is added), so that they are the plain version's to the bit: the
// variances cancel (E[a^2] - mu^2 with both near 0.3) and are then divided by
// d2, which comes down to C2, so a sum in another order (separable row and
// column sums) moved the map by up to 1.3e-5, past the 1e-5 it is held to.
struct Sums {
  float a, b, aa, bb, ab;
};

__device__ __forceinline__ float add3(float s, float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(s, x0), x1), x2);
}

__device__ __forceinline__ Sums first_row(const Row3& r) {
  return {__fadd_rn(__fadd_rn(r.a0, r.a1), r.a2), __fadd_rn(__fadd_rn(r.b0, r.b1), r.b2),
          __fadd_rn(__fadd_rn(__fmul_rn(r.a0, r.a0), __fmul_rn(r.a1, r.a1)), __fmul_rn(r.a2, r.a2)),
          __fadd_rn(__fadd_rn(__fmul_rn(r.b0, r.b0), __fmul_rn(r.b1, r.b1)), __fmul_rn(r.b2, r.b2)),
          __fadd_rn(__fadd_rn(__fmul_rn(r.a0, r.b0), __fmul_rn(r.a1, r.b1)), __fmul_rn(r.a2, r.b2))};
}

__device__ __forceinline__ void add_row(Sums& s, const Row3& r) {
  s.a = add3(s.a, r.a0, r.a1, r.a2);
  s.b = add3(s.b, r.b0, r.b1, r.b2);
  s.aa = add3(s.aa, __fmul_rn(r.a0, r.a0), __fmul_rn(r.a1, r.a1), __fmul_rn(r.a2, r.a2));
  s.bb = add3(s.bb, __fmul_rn(r.b0, r.b0), __fmul_rn(r.b1, r.b1), __fmul_rn(r.b2, r.b2));
  s.ab = add3(s.ab, __fmul_rn(r.a0, r.b0), __fmul_rn(r.a1, r.b1), __fmul_rn(r.a2, r.b2));
}

// s / 9 correctly rounded, as avg_pool2d divides: the product with the rounded
// reciprocal, corrected once by its exact remainder
__device__ __forceinline__ float div9(float s) {
  const float q = __fmul_rn(s, kNinth);
  return __fmaf_rn(__fmaf_rn(-9.0f, q, s), kNinth, q);
}

// The clip's argument (1 - n/d)/2 of one window, each term rounded one operation
// at a time as the plain version rounds it (a == b gives n == d), with one
// approximate reciprocal of d (d >= C1*C2 > 0): taken as (d - n)*(1/d)/2, it is
// exactly 0 at a tie whatever the reciprocal's rounding.
__device__ __forceinline__ float ssim_ratio(const Sums& s, float C1, float C2) {
  const float mu_a = div9(s.a), mu_b = div9(s.b);
  const float mu_aa = __fmul_rn(mu_a, mu_a), mu_bb = __fmul_rn(mu_b, mu_b), mu_ab = __fmul_rn(mu_a, mu_b);
  const float sig_a = __fsub_rn(div9(s.aa), mu_aa);
  const float sig_b = __fsub_rn(div9(s.bb), mu_bb);
  const float sig_ab = __fsub_rn(div9(s.ab), mu_ab);
  const float n1 = __fadd_rn(2.0f * mu_ab, C1), n2 = __fadd_rn(2.0f * sig_ab, C2);
  const float d1 = __fadd_rn(__fadd_rn(mu_aa, mu_bb), C1), d2 = __fadd_rn(__fadd_rn(sig_a, sig_b), C2);
  const float n = __fmul_rn(n1, n2), d = __fmul_rn(d1, d2);
  float rd;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rd) : "f"(d));
  return __fsub_rn(d, n) * rd * 0.5f;
}

// K2's tile: kFwdCols columns (one per thread of a strip), kFwdStrips strips of
// ROWS rows, staged with a one-pixel halo
constexpr int kFwdCols = 64;
constexpr int kFwdStrips = kThreads / kFwdCols;  // 4
constexpr int kFwdStageW = kFwdCols + 2;         // 66

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads, 4)
photometric_map_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           float* __restrict__ out, int C, int H, int W,
                           float alpha, float C1, float C2) {
  constexpr int kTileH = kFwdStrips * ROWS;
  constexpr int kStageH = kTileH + 2;
  constexpr int kStageN = kFwdStageW * kStageH;
  constexpr int kPer = (kStageN + kThreads - 1) / kThreads;  // staged elements per thread
  __shared__ __align__(16) float sa[2][kStageN];
  __shared__ __align__(16) float sb[2][kStageN];
  __shared__ int row_off[kStageH];
  __shared__ int col_off[kFwdStageW];

  const int bi = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kFwdCols;
  const int tid = threadIdx.x;
  const int col = tid % kFwdCols, strip = tid / kFwdCols;
  const long long plane = (long long)H * W;

  // the reflection, once per staged row and column
  if (tid < kStageH) row_off[tid] = reflect(ty0 - 1 + tid, H) * W;
  else if (tid - kStageH < kFwdStageW) col_off[tid - kStageH] = reflect(tx0 - 1 + tid - kStageH, W);
  __syncthreads();
  // this thread's staged elements k = tid + i*256 of the row-major 34x66 (or 18x66) tile:
  // their plane offsets, once for every channel and both inputs
  int off[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = tid + i * kThreads;
    off[i] = k < kStageN ? row_off[k / kFwdStageW] + col_off[k % kFwdStageW] : 0;
  }
  constexpr bool kAsync = sizeof(T) == 4;  // float32: cp.async; bfloat16: loads held in registers
  // float32: channel c's tile into buffer buf with cp.async, one commit group
  auto stage_async = [&](int c, int buf) {
    const T* pa = a + ((long long)bi * C + c) * plane;
    const T* pb = b + ((long long)bi * C + c) * plane;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (tid + i * kThreads < kStageN) {
        copy4(&sa[buf][tid + i * kThreads], pa + off[i]);
        copy4(&sb[buf][tid + i * kThreads], pb + off[i]);
      }
    }
    cp_async_commit();
  };
  // bfloat16: channel c's values into registers (in flight while the previous channel
  // is summed), then, after that, into buffer buf as float32
  unsigned short held_a[kAsync ? 1 : kPer], held_b[kAsync ? 1 : kPer];
  auto fetch = [&](int c) {
    const unsigned short* pa = reinterpret_cast<const unsigned short*>(a) + ((long long)bi * C + c) * plane;
    const unsigned short* pb = reinterpret_cast<const unsigned short*>(b) + ((long long)bi * C + c) * plane;
#pragma unroll
    for (int i = 0; i < (kAsync ? 0 : kPer); ++i) {
      held_a[i] = __ldg(pa + off[i]);
      held_b[i] = __ldg(pb + off[i]);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < (kAsync ? 0 : kPer); ++i) {
      if (tid + i * kThreads < kStageN) {
        sa[buf][tid + i * kThreads] = __bfloat162float(__ushort_as_bfloat16(held_a[i]));
        sb[buf][tid + i * kThreads] = __bfloat162float(__ushort_as_bfloat16(held_b[i]));
      }
    }
  };

  float acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) acc[j] = 0.0f;
  const float k_l1 = 1.0f - alpha;

  if (kAsync) {
    stage_async(0, 0);
  } else {
    fetch(0);
    put(0);
  }
  for (int c = 0; c < C; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < C;
    if (kAsync) {
      if (more) {
        stage_async(c + 1, buf ^ 1);  // its buffer was last read before the previous barrier
        cp_async_wait_prior();        // channel c's copies have landed
      } else {
        cp_async_wait_all();
      }
    } else if (more) {
      fetch(c + 1);
    }
    __syncthreads();
    // this thread's column down its strip: the window of output row j is staged rows j..j+2
    const float* ra = &sa[buf][strip * ROWS * kFwdStageW + col];
    const float* rb = &sb[buf][strip * ROWS * kFwdStageW + col];
    Row3 r0 = load_row(ra, rb, 0);
    Row3 r1 = load_row(ra, rb, kFwdStageW);
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const Row3 r2 = load_row(ra, rb, (j + 2) * kFwdStageW);
      Sums s = first_row(r0);
      add_row(s, r1);
      add_row(s, r2);
      acc[j] += alpha * fminf(fmaxf(ssim_ratio(s, C1, C2), 0.0f), 1.0f) + k_l1 * fabsf(r1.a1 - r1.b1);
      r0 = r1;
      r1 = r2;
    }
    if (!kAsync && more) put(buf ^ 1);  // read last before the previous barrier
    __syncthreads();  // buffer buf is staged again for channel c + 2
  }

  const int gx = tx0 + col;
  if (gx < W) {
    const float inv_c = 1.0f / (float)C;
    float* dst = out + (long long)bi * plane + gx;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int gy = ty0 + strip * ROWS + j;
      if (gy < H) dst[(long long)gy * W] = acc[j] * inv_c;
    }
  }
}

template <typename T>
void launch_fwd(bool tall, dim3 grid, cudaStream_t s, const T* a, const T* b, float* out, int C, int H, int W,
                float alpha, float C1, float C2) {
  if (tall) photometric_map_fwd_kernel<T, 8><<<grid, kThreads, 0, s>>>(a, b, out, C, H, W, alpha, C1, C2);
  else photometric_map_fwd_kernel<T, 4><<<grid, kThreads, 0, s>>>(a, b, out, C, H, W, alpha, C1, C2);
}

}  // namespace

extern "C" {

// Launches on `stream` of CUDA device `device` (made current for the launch,
// the caller's device restored after it), does not synchronise, allocates
// nothing. Returns cudaGetLastError() (0 = launched). Requires H >= 2 and W >= 2.
int sde_photometric_map_fwd(const void* a, const void* b, void* out, int B, int C, int H,
                            int W, float alpha, float C1, float C2, int is_bf16,
                            int device, void* stream) {
  sde::DeviceGuard guard(device);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned gx = (unsigned)((W + kFwdCols - 1) / kFwdCols);
  // 32-row tiles where they fill the card once at 4 blocks per SM (132 SMs), else 16-row
  // tiles: twice the blocks for the small planes
  const bool tall = (long long)gx * ((H + 31) / 32) * B >= 4 * 132;
  const dim3 grid(gx, (unsigned)(tall ? (H + 31) / 32 : (H + 15) / 16), (unsigned)B);
  if (is_bf16) {
    launch_fwd(tall, grid, s, (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out, C, H, W, alpha, C1, C2);
  } else {
    launch_fwd(tall, grid, s, (const float*)a, (const float*)b, (float*)out, C, H, W, alpha, C1, C2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K4, backward: the analytic VJP of the map above with respect to a and b.
// With g the cotangent of the [B,1,H,W] output scaled by 1/C, and per channel
// the window means mu_a, mu_b, the (co)variances sig_a, sig_b, sig_ab,
//   n1 = 2 mu_a mu_b + C1, n2 = 2 sig_ab + C2, d1 = mu_a^2 + mu_b^2 + C1,
//   d2 = sig_a + sig_b + C2, q = n1 n2 / (d1 d2), r = (1 - q) / 2,
// the clip passes gradient where 0 < r < 1 (strictly). Per centre pixel c:
//   t = -alpha g[c] / 2 (0 outside the clip's range), d = d1 d2, g_n = t / d,
//   g_d = -t n / d^2 = -g_n q,  f_ab = 2 g_n n1,  f_d2 = g_d d1,
//   f_mu_a = 2 mu_b g_n n2 + 2 mu_a g_d d2 - 2 mu_a f_d2 - mu_b f_ab
// (f_mu_b is the mirror), and per pixel p
//   g_a[p] = PT(f_mu_a)[p] + 2 a[p] PT(f_d2)[p] + b[p] PT(f_ab)[p]
//            + (1 - alpha) g[p] sign(a[p] - b[p]),      sign(0) = 0,
//   g_b[p] = PT(f_mu_b)[p] + 2 b[p] PT(f_d2)[p] + a[p] PT(f_ab)[p] - (the L1 term).
// PT is the adjoint of the reflect-padded 3x3 mean, in gather form: pixel p
// collects the centres within one pixel per axis, a centre counting twice
// where the reflection shows p to it a second time (per axis: p == 1 with
// c == 0, and p == n-2 with c == n-1), all divided by 9.
//
// Replaces _bwd_kernel (via _pallas_backward; math in _photo_vjp_plane and
// _pool9_adjoint_plane) of simpledepthestimation_tpu/ops/pallas_photometric.py,
// which holds a whole plane on chip per grid step and has no tiled form.
//
// Bound on this card: bytes, B*H*W*(2*s*C + 4 + 4*C*k) for k = 1 or 2 float32
// outputs, but only just: ~150 flops per pixel and channel are near the
// float32 rate's balance, and the instructions that carry them (shared-memory
// loads, address arithmetic, the reciprocal) are what limits this kernel: the
// SASS holds ~100 instructions per window centre and ~60 per pixel per channel.
// Design, for instruction count and occupancy:
// - One block of 256 threads per 32x62 output tile of one channel of one batch
//   item (channels are independent but for g, so they are blocks of their own:
//   more blocks for the small planes, and no channel loop to pipeline). The
//   tile's 34x64 window centres (halo 1) give one centre column to each of 64
//   threads and split the rows in 4 strips; the 36x66 staged a, b (halo 2, the
//   reflection folded into the staging offsets) cost 1.20x the tile's reads,
//   served by L2. They are copied with cp.async (float32) while the block
//   stages g (times 1/C) at the centres.
// - Stage A walks each thread's centre column down its strip with separable
//   3-tap sums: 6 shared loads per centre give the row sums of a, b, a*a, b*b,
//   a*b, and the column sums come from a ring of three rows in registers (the
//   loop unrolled, so the ring needs no copies). The window means use a
//   constant 1/9; one approximate reciprocal of d serves both the clip's ratio,
//   taken as (d - n)/(2d), and the gradient (g_d = -g_n n/d).
// - Stage B walks each thread's pixel column the same way over the fields
//   with the weights of the reflection's adjoint (row sums from shared memory,
//   column sums in a register ring) and writes the gradients.
// - 53,824 bytes of shared memory (62,528 with both gradients) and at most 64
//   registers a thread: 4 blocks (32 warps) per SM, 3 with both gradients.
// The terms n1, d1, n2, d2 and the window sums are rounded one operation at a
// time, identically for a and b, so that a == b gives n == d, ratio 0 and
// exactly zero gradient, as the plain version does. A null output pointer
// skips that gradient (and its field). Every output is written by one thread:
// no atomics, deterministic. Any plane H, W >= 2.

namespace {

constexpr int kBwdTileW = 62, kBwdTileH = 32;            // output pixels of a tile
constexpr int kBwdCols = kBwdTileW + 2;                   // 64 centre columns = threads of a strip
constexpr int kBwdRows = kBwdTileH + 2;                   // 34 centre rows
constexpr int kStageW = kBwdTileW + 4, kStageH = kBwdTileH + 4;  // 66 x 36 a, b (halo 2)
constexpr int kStage = kStageW * kStageH;                 // 2376
constexpr int kStrips = kThreads / kBwdCols;              // 4
constexpr int kField = kBwdRows * kBwdCols;               // 2176
constexpr int kMaxStripRows = (kBwdRows + kStrips - 1) / kStrips;  // 9: stage A's strips have 8 or 9 rows
constexpr int kBwdRowsPerStrip = kBwdTileH / kStrips;     // 8: stage B's

template <typename T>
__device__ __forceinline__ void stage_ab(float* sa, float* sb, const T* pa, const T* pb, int H,
                                         int W, int ty0, int tx0, int tid) {
#pragma unroll
  for (int i = 0; i < (kStage + kThreads - 1) / kThreads; ++i) {
    const int k = tid + i * kThreads;
    if (k < kStage) {
      const int off = reflect(ty0 + k / kStageW - 2, H) * W + reflect(tx0 + k % kStageW - 2, W);
      copy4(sa + k, pa + off);
      copy4(sb + k, pb + off);
    }
  }
  cp_async_commit();
}

// the five row sums of one staged row at a centre column (the squares and the
// product with the same rounding steps, so that a == b gives equal sums)
struct RowSums {
  float a, b, aa, bb, ab;
};

__device__ __forceinline__ RowSums row_sums(const float* sa, const float* sb, int at) {
  const float a0 = sa[at], a1 = sa[at + 1], a2 = sa[at + 2];
  const float b0 = sb[at], b1 = sb[at + 1], b2 = sb[at + 2];
  RowSums h;
  h.a = __fadd_rn(__fadd_rn(a0, a1), a2);
  h.b = __fadd_rn(__fadd_rn(b0, b1), b2);
  h.aa = __fmaf_rn(a2, a2, __fmaf_rn(a1, a1, __fmul_rn(a0, a0)));
  h.bb = __fmaf_rn(b2, b2, __fmaf_rn(b1, b1, __fmul_rn(b0, b0)));
  h.ab = __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
  return h;
}

// One block per (tile, channel, batch item). Shared memory: a, b [kStage] each,
// g / C at the centres [kField], then the fields [kField] each: f_d2, f_ab,
// f_mu_a if WANT_A, f_mu_b if WANT_B.
template <typename T, bool WANT_A, bool WANT_B>
__global__ void __launch_bounds__(kThreads, (WANT_A && WANT_B) ? 3 : 4)
photometric_map_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           const float* __restrict__ g, float* __restrict__ g_a,
                           float* __restrict__ g_b, int C, int H, int W, float alpha,
                           float C1, float C2) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = smem + kStage;
  float* sg = smem + 2 * kStage;
  float* fields = sg + kField;
  constexpr int kMuA = 2, kMuB = WANT_A ? 3 : 2;  // field indices

  const int bi = blockIdx.z / C, c = blockIdx.z % C;
  const int ty0 = blockIdx.y * kBwdTileH, tx0 = blockIdx.x * kBwdTileW;
  const int col = threadIdx.x % kBwdCols, strip = threadIdx.x / kBwdCols;
  const long long plane = (long long)H * W;
  const long long chan = ((long long)bi * C + c) * plane;
  stage_ab(sa, sb, a + chan, b + chan, H, W, ty0, tx0, threadIdx.x);

  // g at the centres (clamped: a centre outside the image has no field anyway)
  {
    const float* gp = g + (long long)bi * plane;
    const float inv_c = 1.0f / (float)C;
    const int gx = min(max(tx0 - 1 + col, 0), W - 1);
    for (int r = strip; r < kBwdRows; r += kStrips) {
      const int gy = min(max(ty0 - 1 + r, 0), H - 1);
      sg[r * kBwdCols + col] = __ldg(gp + (long long)gy * W + gx) * inv_c;
    }
  }
  const float k_ratio = -0.5f * alpha, k_l1 = 1.0f - alpha;
  cp_async_wait_all();  // no copy in flight for bfloat16: a no-op
  __syncthreads();

  // stage A: the fields at this thread's centre column and strip of centre rows,
  // unrolled so that the ring of row sums lives in registers
  {
    const int cx = tx0 - 1 + col;
    const bool cx_in = cx >= 0 && cx < W;
    const int a_begin = strip * kBwdRows / kStrips;
    const int a_rows = (strip + 1) * kBwdRows / kStrips - a_begin;
    const int cy0 = ty0 - 1 + a_begin;
    const float* ra = sa + a_begin * kStageW + col;
    const float* rb = sb + a_begin * kStageW + col;
    const float* gq = sg + a_begin * kBwdCols + col;
    float* fa = fields + a_begin * kBwdCols + col;
    RowSums h0 = row_sums(ra, rb, 0);
    RowSums h1 = row_sums(ra, rb, kStageW);
#pragma unroll
    for (int i = 0; i < kMaxStripRows; ++i) {
      if (i < a_rows) {
        const RowSums h2 = row_sums(ra, rb, (i + 2) * kStageW);
        float o_d2 = 0.f, o_ab = 0.f, o_mu_a = 0.f, o_mu_b = 0.f;
        if (cx_in && (unsigned)(cy0 + i) < (unsigned)H) {
          const float s_a = __fadd_rn(__fadd_rn(h0.a, h1.a), h2.a);
          const float s_b = __fadd_rn(__fadd_rn(h0.b, h1.b), h2.b);
          const float s_aa = __fadd_rn(__fadd_rn(h0.aa, h1.aa), h2.aa);
          const float s_bb = __fadd_rn(__fadd_rn(h0.bb, h1.bb), h2.bb);
          const float s_ab = __fadd_rn(__fadd_rn(h0.ab, h1.ab), h2.ab);
          const float mu_a = __fmul_rn(s_a, kNinth), mu_b = __fmul_rn(s_b, kNinth);
          const float mu_aa = __fmul_rn(mu_a, mu_a), mu_bb = __fmul_rn(mu_b, mu_b), mu_ab = __fmul_rn(mu_a, mu_b);
          const float sig_a = __fsub_rn(__fmul_rn(s_aa, kNinth), mu_aa);
          const float sig_b = __fsub_rn(__fmul_rn(s_bb, kNinth), mu_bb);
          const float sig_ab = __fsub_rn(__fmul_rn(s_ab, kNinth), mu_ab);
          const float n1 = __fadd_rn(2.0f * mu_ab, C1), n2 = __fadd_rn(2.0f * sig_ab, C2);
          const float d1 = __fadd_rn(__fadd_rn(mu_aa, mu_bb), C1), d2 = __fadd_rn(__fadd_rn(sig_a, sig_b), C2);
          const float n = __fmul_rn(n1, n2), d = __fmul_rn(d1, d2);
          // one approximate reciprocal of d (d >= C1*C2 > 0) serves the ratio and the
          // gradient; the ratio is (d - n)/(2d), so a tie (n == d) gives exactly 0
          float rd;
          asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rd) : "f"(d));
          const float ratio = __fsub_rn(d, n) * rd * 0.5f;
          if (ratio > 0.0f && ratio < 1.0f) {
            const float g_n = k_ratio * gq[i * kBwdCols] * rd;
            const float g_d = -g_n * (n * rd);
            const float g_n1 = g_n * n2;
            const float g_d1 = g_d * d2, g_d2 = g_d * d1;
            o_ab = 2.0f * g_n * n1;
            o_d2 = g_d2;
            if (WANT_A) o_mu_a = 2.0f * mu_b * g_n1 + 2.0f * mu_a * g_d1 - 2.0f * mu_a * g_d2 - mu_b * o_ab;
            if (WANT_B) o_mu_b = 2.0f * mu_a * g_n1 + 2.0f * mu_b * g_d1 - 2.0f * mu_b * g_d2 - mu_a * o_ab;
          }
        }
        fa[i * kBwdCols] = o_d2;
        fa[kField + i * kBwdCols] = o_ab;
        if (WANT_A) fa[kMuA * kField + i * kBwdCols] = o_mu_a;
        if (WANT_B) fa[kMuB * kField + i * kBwdCols] = o_mu_b;
        h0 = h1;
        h1 = h2;
      }
    }
  }
  __syncthreads();

  // stage B: the weighted 3x3 gather of the fields at this thread's pixel column and
  // strip of pixel rows, and the gradients. The adjoint's weights (multiplicity: 2
  // where the reflection shows a pixel to a centre twice, else 1) differ from 1 only
  // beside the border: 1 + (p == 1) for the centre before p, 1 + (p == n - 2) for the
  // centre after it, 1 for p's own
  const int px = tx0 + col;
  if (col >= kBwdTileW || px >= W) return;
  const float wc0 = px == 1 ? 2.0f : 1.0f, wc2 = px == W - 2 ? 2.0f : 1.0f;
  const int b_begin = strip * kBwdRowsPerStrip;
  const int py0 = ty0 + b_begin;
  const float* fb = fields + b_begin * kBwdCols + col;
  const float* gb = sg + (b_begin + 1) * kBwdCols + col + 1;
  const float* va_at = sa + (b_begin + 2) * kStageW + col + 2;
  const float* vb_at = sb + (b_begin + 2) * kStageW + col + 2;
  // weighted row sum of field k at centre row i (of this strip) for this pixel column
  auto hrow = [&](int k, int i) {
    const float* p = fb + k * kField + i * kBwdCols;
    return fmaf(wc2, p[2], fmaf(wc0, p[0], p[1]));
  };
  float d2_0 = hrow(0, 0), d2_1 = hrow(0, 1), ab_0 = hrow(1, 0), ab_1 = hrow(1, 1);
  float ma_0 = 0.f, ma_1 = 0.f, mb_0 = 0.f, mb_1 = 0.f;
  if (WANT_A) { ma_0 = hrow(kMuA, 0); ma_1 = hrow(kMuA, 1); }
  if (WANT_B) { mb_0 = hrow(kMuB, 0); mb_1 = hrow(kMuB, 1); }
  const long long own = chan + (long long)py0 * W + px;
  float* out_a = WANT_A ? g_a + own : nullptr;  // an output not written stays null
  float* out_b = WANT_B ? g_b + own : nullptr;
#pragma unroll
  for (int i = 0; i < kBwdRowsPerStrip; ++i) {
    const int py = py0 + i;
    if (py >= H) break;
    const float wr0 = py == 1 ? 2.0f : 1.0f, wr2 = py == H - 2 ? 2.0f : 1.0f;
    const float d2_2 = hrow(0, i + 2), ab_2 = hrow(1, i + 2);
    const float t_d2 = fmaf(wr2, d2_2, fmaf(wr0, d2_0, d2_1));
    const float t_ab = fmaf(wr2, ab_2, fmaf(wr0, ab_0, ab_1));
    const float va = va_at[i * kStageW], vb = vb_at[i * kStageW];
    const float diff = va - vb;
    const float sgn = (float)(diff > 0.0f) - (float)(diff < 0.0f);
    const float l1 = k_l1 * gb[i * kBwdCols] * sgn;
    if (WANT_A) {
      const float ma_2 = hrow(kMuA, i + 2);
      const float t_mu = fmaf(wr2, ma_2, fmaf(wr0, ma_0, ma_1));
      *out_a = (t_mu + 2.0f * va * t_d2 + vb * t_ab) * kNinth + l1;
      out_a += W;
      ma_0 = ma_1;
      ma_1 = ma_2;
    }
    if (WANT_B) {
      const float mb_2 = hrow(kMuB, i + 2);
      const float t_mu = fmaf(wr2, mb_2, fmaf(wr0, mb_0, mb_1));
      *out_b = (t_mu + 2.0f * vb * t_d2 + va * t_ab) * kNinth - l1;
      out_b += W;
      mb_0 = mb_1;
      mb_1 = mb_2;
    }
    d2_0 = d2_1;
    d2_1 = d2_2;
    ab_0 = ab_1;
    ab_1 = ab_2;
  }
}

constexpr int bwd_smem_bytes(bool want_a, bool want_b) {
  return (2 * kStage + kField * (3 + (want_a ? 1 : 0) + (want_b ? 1 : 0))) * (int)sizeof(float);
}

template <typename T, bool WANT_A, bool WANT_B>
void launch_bwd(dim3 grid, cudaStream_t s, int device, const T* a, const T* b, const float* g,
                float* g_a, float* g_b, int C, int H, int W, float alpha, float C1, float C2) {
  constexpr int bytes = bwd_smem_bytes(WANT_A, WANT_B);
  static bool opted_in[64] = {};  // per device: above 48 KB needs the kernel's opt-in
  auto kernel = photometric_map_bwd_kernel<T, WANT_A, WANT_B>;
  if (device < 0 || device >= 64 || !opted_in[device]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (device >= 0 && device < 64) opted_in[device] = true;
  }
  kernel<<<grid, kThreads, bytes, s>>>(a, b, g, g_a, g_b, C, H, W, alpha, C1, C2);
}

template <typename T>
void launch_bwd_for(bool want_a, bool want_b, dim3 grid, cudaStream_t s, int device, const T* a,
                    const T* b, const float* g, float* g_a, float* g_b, int C, int H, int W,
                    float alpha, float C1, float C2) {
  if (want_a && want_b)
    launch_bwd<T, true, true>(grid, s, device, a, b, g, g_a, g_b, C, H, W, alpha, C1, C2);
  else if (want_a)
    launch_bwd<T, true, false>(grid, s, device, a, b, g, g_a, g_b, C, H, W, alpha, C1, C2);
  else
    launch_bwd<T, false, true>(grid, s, device, a, b, g, g_a, g_b, C, H, W, alpha, C1, C2);
}

}  // namespace

extern "C" {

// g is float32 [B,1,H,W]; g_a and g_b are float32 [B,C,H,W], either may be
// null (that gradient is skipped; not both). Same launch contract as the
// forward; requires H*W < 2^31.
int sde_photometric_map_bwd(const void* a, const void* b, const void* g, void* g_a, void* g_b,
                            int B, int C, int H, int W, float alpha, float C1, float C2,
                            int is_bf16, int device, void* stream) {
  sde::DeviceGuard guard(device);
  dim3 grid((unsigned)((W + kBwdTileW - 1) / kBwdTileW), (unsigned)((H + kBwdTileH - 1) / kBwdTileH),
            (unsigned)(B * C));
  cudaStream_t s = (cudaStream_t)stream;
  const bool want_a = g_a != nullptr, want_b = g_b != nullptr;
  if (!want_a && !want_b) return 0;
  if (is_bf16) {
    launch_bwd_for<__nv_bfloat16>(want_a, want_b, grid, s, device, (const __nv_bfloat16*)a,
                                  (const __nv_bfloat16*)b, (const float*)g, (float*)g_a,
                                  (float*)g_b, C, H, W, alpha, C1, C2);
  } else {
    launch_bwd_for<float>(want_a, want_b, grid, s, device, (const float*)a, (const float*)b,
                          (const float*)g, (float*)g_a, (float*)g_b, C, H, W, alpha, C1, C2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
