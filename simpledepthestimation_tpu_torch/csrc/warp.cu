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
// Design: one thread per output pixel, and one block per 8 x 32 tile of
// output pixels of one plane. A warp reads 32 consecutive coordinates and
// writes 32 consecutive results per channel (128 bytes each); the block's
// gathers fall on a 2D neighbourhood of the source, which L1 serves well: with
// a smooth warp field the corner rows of one output row are the next output
// row's too. The corner weights and masks are computed once for all channels,
// with each corner's mask folded into its x-weight (for a finite image the
// same bits as zeroing the masked value).
// 8 blocks of 256 threads per SM: the gathers' latency is hidden by
// occupancy. Two alternatives measured slower on the card: 4 pixels a thread
// with 16-byte coordinate loads and stores and all 16*C corner loads in flight
// before the first store (90-128 registers, 2 blocks per SM), and gathers
// from the block's source box staged in shared memory (the box must be copied
// before any gather starts and, for view-synthesis coordinates, often does not
// fit). Arithmetic is float32 for both image types. No shared memory, no
// synchronisation.
//
// K3, backward in the coordinates: with v00..v11 the four masked corner values
// of channel c and wx, wy the fractions,
//   dx[b,i,j] = sum_c ct[b,c,i,j] * ((v01 - v00)(1 - wy) + (v11 - v10) wy)
//   dy[b,i,j] = sum_c ct[b,c,i,j] * ((v10 - v00)(1 - wx) + (v11 - v01) wx)
// (floor has derivative zero). Replaces _tiled_bwd_kernel (via
// _call_tiled_bwd), _bwd_kernel (via _call_bwd_coords) and _bwd_kernel_v2 (via
// _call_bwd_coords_v2) of the same file, which fold both sums into one banded
// matrix product per tile. Bound: bytes, B*H*W*(8 + 8 + 2*s*C): coordinates in,
// two cotangent planes out, per channel one image value and one ct value
// (0.0470 ms at [32,3,192,640] float32, 0.0329 bfloat16, 0.0244 at the RGB-D
// warp's [32,4,128,416] float32).
// Design: K1's block (one thread per output pixel, 8 x 32 tiles of one plane:
// the corner rows one output row gathers are the next rows' too, and L1 keeps
// them) and K1's corner routine (so forward and backward agree on every clamp
// and mask), 32-bit offsets into a plane, the coordinates read through the
// read-only path. The four clamped corners are always loadable, so each is
// loaded unconditionally and its mask applied as a select on the value; all
// 4*C corner loads and C cotangent loads of a pixel are in flight before the
// sums, the channel loop compiled for C = 3 (MonoDepth2) and C = 4 (the RGB-D
// warp), the generic loop four channels at a time. Every pixel goes through
// the same loads and sums, so a non-finite cotangent gives NaN wherever the
// plain version's does. The sums keep the plain version's order (difference,
// then weight, channel after channel) in float32; each output has one writer,
// no atomics, so the result is deterministic. ct is read in the image's type.
// Resources (ptxas -v, sm_90a): C = 3 and 4, float32 and bfloat16: 32
// registers, no spills, __launch_bounds__(256, 8): 8 blocks (64 warps) per SM;
// the generic loop __launch_bounds__(256, 4): 55 (bfloat16 53) registers, no
// spills (at 6 blocks, 40 registers, it spilled 28-36 bytes). Measured
// (chip_smoke.py --kernels-only, NVIDIA H100 80GB HBM3, 700 W, device time,
// two runs): 0.0648 / 0.0652 ms at [32,3,192,640] float32 (the earlier form,
// a flat grid of 256 consecutive pixels a block, 64-bit offsets, loads
// branched on their masks, in the same call: 0.1028 / 0.1027), bfloat16
// 0.0578 / 0.0589 (0.0926), the RGB-D warp 0.0339 (0.0525). Where 8/9 of the
// pixels fall wholly outside (uniform coordinates over three planes) it loads
// what the earlier form skipped: 0.0827 (0.0888), and on the small planes
// slower than it (0.0058 against 0.0045 at [32,3,48,160]). Measured in an
// earlier call and not shipped, each on a tree that shipped it (view
// synthesis at [32,3,192,640] float32 / bfloat16, that uniform case, the
// RGB-D warp): a skip of the wholly outside pixels 0.0644 / 0.0590, 0.0545,
// 0.0302-0.0337 (it answered 0 where a non-finite cotangent gives NaN); two
// neighbouring pixels of a row a thread (8 x 64 tiles, 8-byte coordinate and
// output accesses, 40-64 registers, 4 blocks per SM) 0.0699 / 0.0563, 0.0591,
// 0.0387; loads branched on their own corner's mask 0.0664 / 0.0601, 0.0557,
// 0.0427 (spills at C = 4); the channel loop not specialised 0.0840 / 0.0782,
// 0.0791, 0.0404. Not tried: staging the block's source box in shared memory
// (slower than the direct gathers for K1, see above).
//
// K5, backward in the image (coordinates held constant): the transpose of K1,
//   d_img[b,c,r,w] = sum over (i,j) and corners (r,w) of ct[b,c,i,j] * weight,
// with the corner weights (1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx*wy. Replaces
// _img_ct_kernel (via warp_image_cotangent) of the same file, which writes the
// scatter as a product of one-hot row and column matrices because its target
// has no scatter. Bound: bytes, B*Ho*Wo*(8 + s*C) read + B*Hi*Wi*C*4 written
// (0.0163 ms at [32,3,128,416] float32). What sets the time is the scatter's
// float32 atomics in L2: corners that lanes scatter cost one L2 request each,
// and the adds that many pixels put on one address (clamped coordinates: the
// image's corners and border) serialise there.
// Design: one thread per output pixel, 256 consecutive pixels of a plane per
// block, K1's corners_at (so the three kernels agree on every clamp and mask),
// float32 adds into the zero-filled float32 d_img, corners of weight 0 and
// channels with ct == 0 skipped. Each warp takes one of three paths:
// - sparse (at most 16 of its pixels land in the image): each lane adds its own
//   corners, a row's two in one 16-byte vector add (atomicAdd on float4, sm_90:
//   one L2 request, not two) where they share a 16-byte segment;
// - coalesced (its top-left corners on at most 10 cache lines, at most 8 of them
//   on the previous lane's address: a near-identity or smooth warp): one
//   instruction per corner of every lane, which L2 takes as a few requests, and
//   where a lane's right corner is the next lane's left one the next lane adds
//   both (a shuffle): one add per address and row instead of two;
// - dense (scattered lanes, or many on one address: clamped coordinates): per row
//   of corners, the lanes whose corners fall in one 16-byte segment
//   (__match_any_sync on the segment, any set of lanes) sum their four-float
//   pieces with shuffles, log2 of the group's size in rounds, and the group's
//   lowest lane adds them with one vector add: 32 pixels clamped onto one image
//   corner become one request.
// The zero fill stays the wrapper's torch.zeros: every block's adds must find it
// done and blocks run in no order, so folding it in needs a grid-wide barrier (a
// cooperative, persistent launch) for ~0.006 ms of writes.
// Resources (ptxas -v, sm_90a): __launch_bounds__(256, 6) gives 40 registers,
// 24 bytes spilled, 6 blocks (48 warps) per SM, no shared memory. The
// atomics make the order of the additions, and so the last bits of d_img, vary
// from run to run.
// Measured and not shipped (chip_smoke.py --kernels-only): (a) scalar adds
// aggregated per address in every warp (__match_any_sync on each corner, plus the
// neighbour merge), on K1's 8 x 32 tiles: 0.1728 ms for view synthesis, 0.0848
// where few pixels land in the image (uniform_3x_plane); (b) block-private sums
// in a shared-memory window of the source, flushed with one global add per
// element: a float atomicAdd on shared memory compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN) on sm_90, and 32 lanes on one address took 0.6256 ms;
// (a) and (b) together: 0.2093 ms for view synthesis.

#include "common.cuh"

namespace {

using sde::ld;

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

// One output pixel of the forward: the corners' offsets into a plane (clamped,
// so always loadable) and the x-weights with each corner's mask folded in.
struct FwdPixel {
  int o00, o01, o10, o11;  // the wrapper keeps Hi*Wi below 2^31
  float a00, a01, a10, a11, wy;
};

__device__ __forceinline__ FwdPixel fwd_pixel(float xv, float yv, int Hi, int Wi) {
  const Corners k = corners_at(xv, yv, Hi, Wi);
  FwdPixel p;
  p.o00 = (int)k.o00;
  p.o01 = (int)k.o01;
  p.o10 = (int)k.o10;
  p.o11 = (int)k.o11;
  p.a00 = k.m00 ? 1.0f - k.wx : 0.0f;
  p.a01 = k.m01 ? k.wx : 0.0f;
  p.a10 = k.m10 ? 1.0f - k.wx : 0.0f;
  p.a11 = k.m11 ? k.wx : 0.0f;
  p.wy = k.wy;
  return p;
}

// the block of K1 and K3: a tile of kTileRows x kTileCols output pixels of one plane
constexpr int kTileRows = 8, kTileCols = kThreads / kTileRows;

template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
warp_bilinear_fwd_kernel(const T* __restrict__ img, const float* __restrict__ x,
                         const float* __restrict__ y, T* __restrict__ out,
                         int C, int Hi, int Wi, int Ho, int Wo) {
  const int row = blockIdx.y * kTileRows + threadIdx.x / kTileCols;
  const int col = blockIdx.x * kTileCols + threadIdx.x % kTileCols;
  if (row >= Ho || col >= Wo) return;
  const int b = blockIdx.z;
  const long long out_plane = (long long)Ho * Wo;
  const long long pix = (long long)row * Wo + col;
  const FwdPixel p = fwd_pixel(__ldg(x + b * out_plane + pix), __ldg(y + b * out_plane + pix), Hi, Wi);
  const long long in_plane = (long long)Hi * Wi;
  const T* src = img + (long long)b * C * in_plane;
  T* dst = out + (long long)b * C * out_plane + pix;
  for (int c = 0; c < C; ++c) {
    const float v00 = ld(src + p.o00), v01 = ld(src + p.o01);
    const float v10 = ld(src + p.o10), v11 = ld(src + p.o11);
    const float top = v00 * p.a00 + v01 * p.a01;
    const float bot = v10 * p.a10 + v11 * p.a11;
    st(dst, top * (1.0f - p.wy) + bot * p.wy);
    src += in_plane;
    dst += out_plane;
  }
}

// One output pixel of the coordinate backward: the corners' offsets into a
// plane (clamped, so always loadable), their masks and the fractions.
struct BwdPixel {
  int o00, o01, o10, o11;  // the wrapper keeps Hi*Wi below 2^31
  bool m00, m01, m10, m11;
  float wx, wy;
};

__device__ __forceinline__ BwdPixel bwd_pixel(float xv, float yv, int Hi, int Wi) {
  const Corners k = corners_at(xv, yv, Hi, Wi);
  return {(int)k.o00, (int)k.o01, (int)k.o10, (int)k.o11, k.m00, k.m01, k.m10, k.m11, k.wx, k.wy};
}

// N consecutive channels of one pixel (from src and g on): all 4*N corner loads and N cotangent
// loads issued first, then the sums in the plain version's order (difference,
// then weight; channel after channel). A masked corner's value is selected
// away after its load, not branched around.
template <int N, typename T>
__device__ __forceinline__ void bwd_channels(const T* __restrict__ src, const T* __restrict__ g,
                                             int in_plane, long long out_plane, const BwdPixel& p,
                                             float& ax, float& ay) {
  float v[N][4], gc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    v[c][0] = ld(src + p.o00);
    v[c][1] = ld(src + p.o01);
    v[c][2] = ld(src + p.o10);
    v[c][3] = ld(src + p.o11);
    gc[c] = ld(g);
    src += in_plane;
    g += out_plane;
  }
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float v00 = p.m00 ? v[c][0] : 0.0f, v01 = p.m01 ? v[c][1] : 0.0f;
    const float v10 = p.m10 ? v[c][2] : 0.0f, v11 = p.m11 ? v[c][3] : 0.0f;
    ax += gc[c] * ((v01 - v00) * (1.0f - p.wy) + (v11 - v10) * p.wy);
    ay += gc[c] * ((v10 - v00) * (1.0f - p.wx) + (v11 - v01) * p.wx);
  }
}

// The channel sums of one pixel. CN > 0: the channel count, fixed at compile
// time (3: MonoDepth2's frames, 4: MotionLearning's RGB-D warp); CN = 0: C
// channels, four at a time.
template <int CN, typename T>
__device__ __forceinline__ void bwd_sums(const T* __restrict__ src, const T* __restrict__ g, int C,
                                         int in_plane, long long out_plane, const BwdPixel& p,
                                         float& ax, float& ay) {
  if constexpr (CN > 0) {
    bwd_channels<CN>(src, g, in_plane, out_plane, p, ax, ay);
  } else {
    int c = 0;
    for (; c + 4 <= C; c += 4) {
      bwd_channels<4>(src, g, in_plane, out_plane, p, ax, ay);
      src += 4LL * in_plane;
      g += 4 * out_plane;
    }
    for (; c < C; ++c) {
      bwd_channels<1>(src, g, in_plane, out_plane, p, ax, ay);
      src += in_plane;
      g += out_plane;
    }
  }
}

// K3: one thread per output pixel, one block per 8 x 32 tile of one plane
template <typename T, int CN>
__global__ void __launch_bounds__(kThreads, CN > 0 ? 8 : 4)
warp_bilinear_bwd_coords_kernel(const T* __restrict__ img, const float* __restrict__ x,
                                const float* __restrict__ y, const T* __restrict__ ct,
                                float* __restrict__ dx, float* __restrict__ dy,
                                int C, int Hi, int Wi, int Ho, int Wo) {
  const int row = blockIdx.y * kTileRows + threadIdx.x / kTileCols;
  const int col = blockIdx.x * kTileCols + threadIdx.x % kTileCols;
  if (row >= Ho || col >= Wo) return;
  const int b = blockIdx.z;
  const long long out_plane = (long long)Ho * Wo;
  const long long at = (long long)row * Wo + col;  // the pixel in its plane
  const long long pix = b * out_plane + at;
  const BwdPixel p = bwd_pixel(__ldg(x + pix), __ldg(y + pix), Hi, Wi);
  const int in_plane = Hi * Wi;
  float ax = 0.0f, ay = 0.0f;
  bwd_sums<CN>(img + (long long)b * C * in_plane, ct + (long long)b * C * out_plane + at, C, in_plane,
               out_plane, p, ax, ay);
  dx[pix] = ax;
  dy[pix] = ay;
}

// the thresholds of K5's per-warp paths (measured on the card: PERF.md)
constexpr int kCoalescedLines = 10;  // a coalesced warp's top-left corners lie on at most this many 128-byte lines
constexpr int kCoalescedDups = 8;    // and at most this many of them on the address of the lane before
constexpr int kSparseLanes = 16;     // a sparse warp has at most this many pixels that add
constexpr unsigned kFull = 0xffffffffu;

// This lane's sum over its group `peers` (the lanes whose key equals its own),
// for NV values at once: a tree over any set of lanes, contiguous or not, in
// log2(group size) rounds of one shuffle per value. The whole group's sum ends
// in its lowest lane. Every lane of the warp takes part.
template <int NV>
__device__ __forceinline__ void group_sums(unsigned peers, unsigned lane, float (&v)[NV]) {
  unsigned rest = peers & (0xfffffffeu << lane);  // the group's lanes above this one
  int rel = __popc(peers & ((1u << lane) - 1u));  // this lane's rank in its group
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);  // 1 + the next lane of the group above, 0 if none
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float t = __shfl_sync(kFull, v[j], (next - 1) & 31);
      if (next) v[j] += t;
    }
    rest &= ~__ballot_sync(kFull, rel & 1);  // lanes of odd rank were added in below
    rel >>= 1;
  }
}

// One atomic add of four consecutive floats at a 16-byte aligned address: on
// sm_90 one reduction request in L2 for the four (atomicAdd on float4, whose
// result is unused: a RED)
__device__ __forceinline__ void red4(float* p, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// Adds the 16-byte segment `seg` of a plane: nothing where all four are 0, a
// scalar add where one is not, else one vector add (scalar adds where the
// plane's segments are not 16-byte aligned)
__device__ __forceinline__ void add_segment(float* plane, int seg, const float (&v)[4], bool vec) {
  const int nz = (v[0] != 0.0f) + (v[1] != 0.0f) + (v[2] != 0.0f) + (v[3] != 0.0f);
  if (nz == 0) return;
  float* p = plane + 4 * (long long)seg;
  if (nz > 1 && vec) {
    red4(p, v);
    return;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (v[s] != 0.0f) atomicAdd(p + s, v[s]);
}

// K5: one thread per output pixel, 256 consecutive pixels of a plane per block
// (a warp is 32 consecutive pixels).
template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
warp_bilinear_bwd_image_kernel(const T* __restrict__ ct, const float* __restrict__ x,
                               const float* __restrict__ y, float* __restrict__ d_img,
                               int C, int Hi, int Wi, int Ho, int Wo) {
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const long long out_plane = (long long)Ho * Wo, in_plane = (long long)Hi * Wi;
  const long long pix = (long long)blockIdx.x * kThreads + tid;
  const bool live = pix < out_plane;
  const int b = blockIdx.y;

  // the four corners (00, 01, 10, 11): plane offsets and weights, 0 where masked
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int o[4] = {0, 0, 0, 0};
  if (live) {
    const Corners k = corners_at(__ldg(x + b * out_plane + pix), __ldg(y + b * out_plane + pix), Hi, Wi);
    w[0] = k.m00 ? (1.0f - k.wx) * (1.0f - k.wy) : 0.0f;
    w[1] = k.m01 ? k.wx * (1.0f - k.wy) : 0.0f;
    w[2] = k.m10 ? (1.0f - k.wx) * k.wy : 0.0f;
    w[3] = k.m11 ? k.wx * k.wy : 0.0f;
    o[0] = (int)k.o00;
    o[1] = (int)k.o01;
    o[2] = (int)k.o10;
    o[3] = (int)k.o11;
  }
  const bool adds = w[0] != 0.0f || w[1] != 0.0f || w[2] != 0.0f || w[3] != 0.0f;
  float* dst = d_img + (long long)b * C * in_plane;
  const T* g = ct + (long long)b * C * out_plane + pix;

  const bool vec = (in_plane & 3) == 0;  // the plane's 16-byte segments are aligned

  // a sparse warp (few of its pixels land in the image): each lane adds its own
  // corners, a row's two in one vector add where they share a segment
  if (__popc(__ballot_sync(kFull, adds)) <= kSparseLanes) {
    if (!adds) return;
    bool pair[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) pair[r] = vec && w[2 * r] != 0.0f && w[2 * r + 1] != 0.0f && (o[2 * r] & 3) < 3;
    for (int c = 0; c < C; ++c, dst += in_plane, g += out_plane) {
      const float gc = ld(g);
      if (gc == 0.0f) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (pair[r]) {
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const int sl = o[2 * r] & 3;
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            if (s == sl) {
              v[s] = gc * w[2 * r];
              v[s + 1] = gc * w[2 * r + 1];
            }
          }
          red4(dst + (o[2 * r] & ~3), v);
        } else {
          if (w[2 * r] != 0.0f) atomicAdd(dst + o[2 * r], gc * w[2 * r]);
          if (w[2 * r + 1] != 0.0f) atomicAdd(dst + o[2 * r + 1], gc * w[2 * r + 1]);
        }
      }
    }
    return;
  }

  // a coalesced warp (its lanes' top-left corners on a few cache lines, few of them
  // on the address of the lane before, as a near-identity warp puts them): each lane
  // adds its own corners, one instruction per corner of every lane, which L2 takes
  // as a few requests
  {
    const int prev = __shfl_up_sync(kFull, o[0], 1);
    const bool prev_adds = __shfl_up_sync(kFull, adds, 1) && lane > 0;
    const bool dup = adds && prev_adds && prev == o[0];
    const bool new_line = adds && (!prev_adds || (prev >> 5) != (o[0] >> 5));
    if (__popc(__ballot_sync(kFull, dup)) <= kCoalescedDups &&
        __popc(__ballot_sync(kFull, new_line)) <= kCoalescedLines) {
      // where a lane's right corner is the next lane's left one (a near-identity warp:
      // nearly always), the next lane adds both: one add per address and row, not two
      bool give[2], take[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int next_left = __shfl_down_sync(kFull, o[2 * r], 1);
        const bool next_has_left = __shfl_down_sync(kFull, w[2 * r] != 0.0f, 1);
        give[r] = lane < 31 && w[2 * r + 1] != 0.0f && next_has_left && next_left == o[2 * r + 1];
        take[r] = __shfl_up_sync(kFull, give[r], 1) && lane > 0;
      }
      if (__all_sync(kFull, !adds)) return;
      for (int c = 0; c < C; ++c, dst += in_plane, g += out_plane) {
        const float gc = adds ? ld(g) : 0.0f;
        if (!__any_sync(kFull, gc != 0.0f)) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float vr = gc * w[2 * r + 1];
          const float from_left = __shfl_up_sync(kFull, vr, 1);
          const float vl = gc * w[2 * r] + (take[r] ? from_left : 0.0f);
          if (w[2 * r] != 0.0f && vl != 0.0f) atomicAdd(dst + o[2 * r], vl);
          if (!give[r] && vr != 0.0f) atomicAdd(dst + o[2 * r + 1], vr);
        }
      }
      return;
    }
  }

  // a dense warp: per row of corners (top, bottom) a lane's piece is the 16-byte
  // segment of its left corner (of its right one where the left adds nothing) with
  // one or both corners in place; the key of a piece is its segment, or a negative
  // number of the lane's own where the row adds nothing. A right corner that falls
  // in the next segment is added on its own.
  int key[2], slot_l[2], slot_r[2];
  bool straddles[2];
  unsigned peers[2];
  bool grouped[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float wl = w[2 * r], wr = w[2 * r + 1];
    const int ol = o[2 * r], orr = o[2 * r + 1];
    key[r] = -1 - (int)(lane * 2 + r);
    slot_l[r] = slot_r[r] = -1;
    straddles[r] = false;
    if (wl != 0.0f) {
      key[r] = ol >> 2;
      slot_l[r] = ol & 3;
      if (wr != 0.0f) {  // the right corner is ol + 1
        if (slot_l[r] < 3) slot_r[r] = slot_l[r] + 1;
        else straddles[r] = true;
      }
    } else if (wr != 0.0f) {
      key[r] = orr >> 2;
      slot_r[r] = orr & 3;
    }
    // the lanes whose piece has this segment; the group's lowest lane adds for all
    peers[r] = __match_any_sync(kFull, key[r]);
    grouped[r] = __any_sync(kFull, peers[r] != (1u << lane));
  }
  for (int c = 0; c < C; ++c, dst += in_plane, g += out_plane) {
    const float gc = adds ? ld(g) : 0.0f;
    if (!__any_sync(kFull, gc != 0.0f)) continue;  // a channel with no cotangent on this warp
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float vl = gc * w[2 * r], vr = gc * w[2 * r + 1];
      float v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = (s == slot_l[r] ? vl : 0.0f) + (s == slot_r[r] ? vr : 0.0f);
      if (grouped[r]) group_sums(peers[r], lane, v);
      if (key[r] >= 0 && (peers[r] & ((1u << lane) - 1u)) == 0u) add_segment(dst, key[r], v, vec);
      if (straddles[r] && vr != 0.0f) atomicAdd(dst + o[2 * r + 1], vr);
    }
  }
}

// K3's launch: the kernel specialised for the channel count where there is one
template <typename T>
void launch_bwd_coords(const T* img, const void* x, const void* y, const T* ct, void* dx, void* dy, int C,
                       int Hi, int Wi, int Ho, int Wo, dim3 grid, cudaStream_t s) {
  const float *xf = (const float*)x, *yf = (const float*)y;
  float *dxf = (float*)dx, *dyf = (float*)dy;
  if (C == 3) {
    warp_bilinear_bwd_coords_kernel<T, 3><<<grid, kThreads, 0, s>>>(img, xf, yf, ct, dxf, dyf, C, Hi, Wi, Ho, Wo);
  } else if (C == 4) {
    warp_bilinear_bwd_coords_kernel<T, 4><<<grid, kThreads, 0, s>>>(img, xf, yf, ct, dxf, dyf, C, Hi, Wi, Ho, Wo);
  } else {
    warp_bilinear_bwd_coords_kernel<T, 0><<<grid, kThreads, 0, s>>>(img, xf, yf, ct, dxf, dyf, C, Hi, Wi, Ho, Wo);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of CUDA device `device` (made current for the launch,
// the caller's device restored after it), does not synchronise, allocates
// nothing. Returns cudaGetLastError() (0 = launched). Requires Hi*Wi < 2^31.
int sde_warp_bilinear_fwd(const void* img, const void* x, const void* y, void* out,
                          int B, int C, int Hi, int Wi, int Ho, int Wo,
                          int is_bf16, int device, void* stream) {
  sde::DeviceGuard guard(device);
  dim3 grid((unsigned)((Wo + kTileCols - 1) / kTileCols), (unsigned)((Ho + kTileRows - 1) / kTileRows),
            (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_bilinear_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)img, (const float*)x, (const float*)y, (__nv_bfloat16*)out, C, Hi, Wi,
        Ho, Wo);
  } else {
    warp_bilinear_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)img, (const float*)x, (const float*)y, (float*)out, C, Hi, Wi, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

// Coordinate cotangents of the forward above; ct has the image's type, dx and
// dy are float32. Same launch contract.
int sde_warp_bilinear_bwd_coords(const void* img, const void* x, const void* y, const void* ct,
                                 void* dx, void* dy, int B, int C, int Hi, int Wi, int Ho,
                                 int Wo, int is_bf16, int device, void* stream) {
  sde::DeviceGuard guard(device);
  const dim3 grid((unsigned)((Wo + kTileCols - 1) / kTileCols), (unsigned)((Ho + kTileRows - 1) / kTileRows),
                  (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch_bwd_coords((const __nv_bfloat16*)img, x, y, (const __nv_bfloat16*)ct, dx, dy, C, Hi, Wi, Ho, Wo, grid, s);
  } else {
    launch_bwd_coords((const float*)img, x, y, (const float*)ct, dx, dy, C, Hi, Wi, Ho, Wo, grid, s);
  }
  return (int)cudaGetLastError();
}

// Image cotangent of the forward above: d_img [B,C,Hi,Wi] float32, which the
// caller has zero-filled, accumulates ct [B,C,Ho,Wo] (the image's type) at
// coordinates x, y [B,Ho,Wo]. Same launch contract.
int sde_warp_bilinear_bwd_image(const void* ct, const void* x, const void* y, void* d_img,
                                int B, int C, int Hi, int Wi, int Ho, int Wo, int is_bf16,
                                int device, void* stream) {
  sde::DeviceGuard guard(device);
  const dim3 grid((unsigned)(((long long)Ho * Wo + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    warp_bilinear_bwd_image_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)ct, (const float*)x, (const float*)y, (float*)d_img, C, Hi, Wi, Ho, Wo);
  } else {
    warp_bilinear_bwd_image_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)ct, (const float*)x, (const float*)y, (float*)d_img, C, Hi, Wi, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

const char* sde_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
