// Hand-written Hopper (sm_90a) kernels for the warps of the rife-v4.6 and
// rife-v2.3 paths.  Plain C interface, loaded with ctypes by
// rife_tpu_torch/native/build.py; the PyTorch wrappers and plain twins are in
// rife_tpu_torch/ops/warp.py.
//
// Replaces (rife_tpu/ops/warp_pallas.py):
//   rife_warp_pair      _warp_kernel_u8_sheared_flow_pair (warp_pallas_pair,
//                       raw flow; _warp_kernel_u8_slab_tall_flow_pair computes
//                       the same function)                      [rife.WarpPair]
//   rife_warp_render    _warp_kernel_u8_sheared_flow_render (warp_pallas_pair
//                       blend=True; _warp_kernel_u8_slab_tall_flow_render is
//                       equivalent)                            [rife.RenderBlend]
//   rife_warp_ds4_pair  _warp_kernel_u8_slab_tall_flow_pair with abs_pos=True on
//                       the tap grid of jax_ops._ds4_abs_positions, plus the two
//                       0.5/0.5 _downsample_axis passes of
//                       jax_ops._op_warp_ds4_pair (warp_pallas_ds4_pair /
//                       _warp_kernel_u8_sheared_ds4_pair compute the same
//                       function)                              [rife.WarpDs4Pair]
//   rife_warp_single    float mode: _warp_pallas_impl -> _warp_kernel (K1, f32)
//                       and _warp_pallas_packed_impl -> _warp_kernel_packed,
//                       _packed_mc, _packed_mct (K2, bf16)  [rife.Warp on v2
//                       contextnet feature maps]; u8 mode:
//                       _warp_pallas_u8_impl_any (K4)  [unpaired rife.Warp of a
//                       frame copy, v2 fusionnet]; raw flow or absolute positions
//                       [rife.WarpDs4 off the pair kernel]
//   rife_warp_ds2       _warp_pallas_u8_ds2_impl -> _warp_kernel_u8_slab_ds2 (K3):
//                       u8-origin warp of a frame copy fused with the exact
//                       half-pixel 1/2 downsample         [rife.WarpDs2, fuse_ds2]
//   rife_warp_spatial   warp_pallas_spatial (S, :2901): one shard's output rows
//                       of a warp over the whole (all-gathered) source, from the
//                       shard's raw flow rows and their first global row; u8 or
//                       float mode, optionally at the 1/4 taps with the two
//                       0.5/0.5 passes           [every warp, height-sharded]
//
// What bounds them on the H100: a backward warp is a data-dependent gather at
// about 2 FLOP per byte, so memory and latency bound it and the tensor cores
// play no part.  Per output pixel and image a thread reads the 2 flow values
// (4 B in bf16), gathers 4 corners x 3 planes (24 B in bf16, at positions the
// flow decides) and writes 3 values (6 B); the ds4 form gathers 4 taps of that
// per 1/4-resolution pixel.  Counted once each (the bound), a u8 pair warp at
// 1088x1920, B=8, bf16 moves ~0.53 GB: 0.16 ms at 3.35 TB/s.  The ds2 form
// gathers as much as a full-resolution warp (the 1/2 downsample reads every
// warped pixel) but writes a quarter of it and no full-resolution
// intermediate.  What keeps a kernel off that bound is latency: a thread
// loads its flow, waits, then gathers at addresses the flow decides, mostly
// served by L1 (__ldg measured fastest of the load paths tried).
//
// K1/K2/K4/K5 (warp_gather_kernel; PERF.md gives the times of each choice
// below against the others on the card):
// - the time falls with the warps an SM holds, so the launch bound holds the
//   kernel to 32 registers (u8 modes, 8 blocks of 256 threads an SM) or 40
//   (float mode, 6 blocks); a prefetch of the next tile's flow by persistent
//   blocks, more gathers in flight per thread (two channels at a time) and
//   floor/round kept off the conversion unit each cost registers and gained
//   nothing;
// - u8 modes (K4, K5 = the same kernel over 2B images): two adjacent output
//   pixels a thread, flow loads and output stores as 2-element vectors;
// - float mode (K1, K2): one pixel a thread (two cost registers), and the
//   grid covers (pixel tile, channel group, image), so the narrow deep
//   contextnet levels (C=256 at 34x60) fill the card; tiles 16 wide and 16
//   tall, whose rows share more source rows in L1 than wide flat tiles;
// - the vector path is a template constant: a branch on it inside the
//   channel loop cost a quarter of the float mode's time;
// - every gather goes to device memory, served mostly by L1.  Staging the
//   block's corner window in shared memory (the u8 modes as one 32-bit word
//   of three u8 values per source pixel, the TPU's _chan_u8 word, each
//   sample converted once; the float mode through two cp.async buffers) was
//   slower on every shape: the block-wide bounding-box reduction, the
//   barriers and windows of ~2x the tile's pixels cost more than the
//   conversions and L1 gathers they save.
//
// K6 (warp_render_kernel) takes K5's levers: the 32-register cap, two
// pixels a thread, vector flow/mask loads and output stores, and keeps one
// warp's corners live at a time.  K7 (warp_ds4_pair_kernel) keeps a thread an
// output with all four taps' gathers in flight at once (up to 64
// registers): on this function more threads with fewer loads in flight each
// measured slower.  The stride-4 taps touch far more bytes than its bound counts:
// DRAM moves 32-byte sectors, so K7 reads every sector of flow rows 4i+1 and
// 4i+2 (1/2 of the flows) and of at least three image rows in four.
//
// K3 (warp_ds2_kernel) keeps one thread per output pixel handling every
// channel, each phase's corner indices and weights computed once for the
// three planes, but walks the four phases one at a time under the 32-register
// cap, so an SM holds more warps (PERF.md section 6 gives the measurements).
// None of the TPU's band/slab/sheared staging or VMEM stripes carries over:
// those exist because a TPU has no gather unit.

// S (warp_spatial_kernel) samples a shard's rows at global positions
// computed in registers from its raw flow rows and row0, exactly as the
// positions tensor the earlier form built (x + fx, (row0 + y) + fy, each an
// f32 add), so no positions tensor is written or read: a thread an output
// pixel (ds4: a 1/4-resolution output, its four taps' corners live, as K7,
// under an 85-register bound: at K7's 64 the row offset and channel loop
// spilled), channel groups as K1/K2 in float mode.  It reads the flow rows once, the
// source rows the positions reach and writes the output once.
//
// Rounding: every f32 operation uses the _rn intrinsics, so nvcc cannot
// contract a multiply and an add into an FMA, and the result follows the twin's
// operation order exactly.  Storage-dtype steps (K6 blend, K7 averages) round
// to bf16 after each operation, as the JAX package's bf16 arithmetic does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv255 = 1.0f / 255.0f;  // == f32(1/255) of the Pallas kernels

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T store(float v);
template <> __device__ __forceinline__ float store<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to the storage dtype and back
template <typename T> __device__ __forceinline__ float q(float v) {
  return to_f(store<T>(v));
}

template <typename T> __device__ __forceinline__ float ldf(const T* p) {
  return to_f(__ldg(p));
}

// u = round(clip(v, 0, 1) * 255): the u8 value of a Split copy of a frame
template <typename T> __device__ __forceinline__ float u8_at(const T* p) {
  float v = fminf(fmaxf(ldf(p), 0.0f), 1.0f);
  return rintf(__fmul_rn(v, 255.0f));
}

struct Corners {
  int i00, i01, i10, i11;  // plane offsets of the four corners
  float w00, w01, w10, w11;
};

// _inkernel_corners: floor/clip indices, clamped fractions, bilinear weights
__device__ __forceinline__ Corners corners(float sx, float sy, int h, int w) {
  int x0 = min(max(static_cast<int>(floorf(sx)), 0), w - 1);
  int y0 = min(max(static_cast<int>(floorf(sy)), 0), h - 1);
  int x1 = min(x0 + 1, w - 1);
  int y1 = min(y0 + 1, h - 1);
  float a = fminf(fmaxf(__fsub_rn(sx, static_cast<float>(x0)), 0.0f), 1.0f);
  float b = fminf(fmaxf(__fsub_rn(sy, static_cast<float>(y0)), 0.0f), 1.0f);
  float oa = __fsub_rn(1.0f, a), ob = __fsub_rn(1.0f, b);
  Corners k;
  k.i00 = y0 * w + x0;
  k.i01 = y0 * w + x1;
  k.i10 = y1 * w + x0;
  k.i11 = y1 * w + x1;
  k.w00 = __fmul_rn(oa, ob);
  k.w01 = __fmul_rn(a, ob);
  k.w10 = __fmul_rn(oa, b);
  k.w11 = __fmul_rn(a, b);
  return k;
}

// (u00*w00 + u01*w01) + (u10*w10 + u11*w11), scaled by 1/255, in f32
template <typename T>
__device__ __forceinline__ float sample(const T* plane, const Corners& k) {
  float top = __fadd_rn(__fmul_rn(u8_at(plane + k.i00), k.w00),
                        __fmul_rn(u8_at(plane + k.i01), k.w01));
  float bot = __fadd_rn(__fmul_rn(u8_at(plane + k.i10), k.w10),
                        __fmul_rn(u8_at(plane + k.i11), k.w11));
  return __fmul_rn(__fadd_rn(top, bot), kInv255);
}

// raw flow (B,2,H,W) at pixel (x, y) -> corners of the sample position
template <typename T>
__device__ __forceinline__ Corners flow_corners(const T* flow, size_t plane,
                                                int x, int y, int h, int w) {
  size_t p = static_cast<size_t>(y) * w + x;
  float sx = __fadd_rn(static_cast<float>(x), ldf(flow + p));
  float sy = __fadd_rn(static_cast<float>(y), ldf(flow + plane + p));
  return corners(sx, sy, h, w);
}

// ---------------------------------------------------------------------------
// K1/K2/K4/K5
// ---------------------------------------------------------------------------

// ((v00*w00 + v01*w01) + v10*w10) + v11*w11 in f32 -- the Pallas kernels'
// order where the four corners fall in one lane tile
__device__ __forceinline__ float feat_sum(float v00, float v01, float v10, float v11,
                                          float w00, float w01, float w10, float w11) {
  float acc = __fmul_rn(v00, w00);
  acc = __fadd_rn(acc, __fmul_rn(v01, w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, w10));
  return __fadd_rn(acc, __fmul_rn(v11, w11));
}

template <typename T> struct Two;
template <> struct Two<float> { using type = float2; };
template <> struct Two<__nv_bfloat16> { using type = __nv_bfloat162; };

// values at p and p+1 (n == 2) or at p alone
template <typename T>
__device__ __forceinline__ float2 ld2(const T* p, int n, bool vec) {
  if (n == 2 && vec) {
    typename Two<T>::type v = __ldg(reinterpret_cast<const typename Two<T>::type*>(p));
    return make_float2(to_f(v.x), to_f(v.y));
  }
  return make_float2(ldf(p), n == 2 ? ldf(p + 1) : 0.0f);
}

__device__ __forceinline__ float2 two_of(float a, float b, float) { return make_float2(a, b); }
__device__ __forceinline__ __nv_bfloat162 two_of(float a, float b, __nv_bfloat16) {
  return __floats2bfloat162_rn(a, b);
}

// v[0] at p and v[1] at p+1 (n == 2), or v[0] alone
template <typename T>
__device__ __forceinline__ void st2(T* p, const float* v, int n, bool vec) {
  if (n == 2 && vec) {
    *reinterpret_cast<typename Two<T>::type*>(p) = two_of(v[0], v[1], T());
    return;
  }
  p[0] = store<T>(v[0]);
  if (n == 2) p[1] = store<T>(v[1]);
}

// K1/K2/K4/K5; why it is shaped so: the header note.  The launch bound holds
// the kernel to 8 (u8) or 6 (float) blocks of 256 threads an SM, 32 or 40
// registers.
//
// A block owns a tile of output pixels, PX adjacent x a thread: u8 modes
// (C == 3, one group, K4/K5) two, float mode (K1/K2) one.  kVec (u8 modes,
// Wo even, rows aligned): both pixels lie in the grid, flow/position loads
// and output stores are 2-element vectors; otherwise scalar, and a second
// pixel past the right edge (odd Wo) gathers at clamped corners and is not
// stored.  Grid y covers (row tile, channel group), the group fastest; grid
// z the images (pair != 0: 2B of them, even z image a and odd z image b of
// batch item z/2).  Output pixel (x, y) of the (Ho,Wo) grid samples at
// (x, y) + flow(x, y) (flow of type P = T), or at the absolute position
// pos(x, y) (P = float).  u8: per channel the two pixels' gathers and u8
// sums.  Float: the group's channels one at a time, the four gathers issued
// before the sum, one cast to T per channel; the groups let the narrow deep
// contextnet levels (C=256 at 34x60) fill the card.
template <typename T, typename P, bool kAbs, bool kU8, bool kVec>
__global__ void __launch_bounds__(256, kU8 ? 8 : 6) warp_gather_kernel(
    const T* __restrict__ img_a, const P* __restrict__ pos_a, T* __restrict__ out_a,
    const T* __restrict__ img_b, const P* __restrict__ pos_b, T* __restrict__ out_b, int pair,
    int c, int group, int ngroups, int h, int w, int ho, int wo) {
  constexpr int PX = kU8 ? 2 : 1;
  static_assert(kU8 || !kVec, "vectors need two pixels a thread");
  if constexpr (kU8) c = 3, ngroups = 1;
  int x = PX * (blockIdx.x * blockDim.x + threadIdx.x);
  int y = (blockIdx.y / ngroups) * blockDim.y + threadIdx.y;
  if (y >= ho || x >= wo) return;
  const int n = PX == 1 ? 1 : kVec ? 2 : min(2, wo - x);
  int b = pair ? blockIdx.z >> 1 : blockIdx.z;
  bool second = pair && (blockIdx.z & 1);
  size_t plane = static_cast<size_t>(h) * w;
  size_t plane_o = static_cast<size_t>(ho) * wo;
  size_t p = static_cast<size_t>(y) * wo + x;
  const P* pos = (second ? pos_b : pos_a) + 2 * plane_o * b + p;
  float2 sx = ld2(pos, n, kVec), sy = ld2(pos + plane_o, n, kVec);
  if (!kAbs) {
    sx.x = __fadd_rn(static_cast<float>(x), sx.x);
    sx.y = __fadd_rn(static_cast<float>(x + 1), sx.y);
    sy.x = __fadd_rn(static_cast<float>(y), sy.x);
    sy.y = __fadd_rn(static_cast<float>(y), sy.y);
  }
  Corners k[PX];
  k[0] = corners(sx.x, sy.x, h, w);
  if constexpr (PX == 2) k[1] = corners(sx.y, sy.y, h, w);
  const T* img = (second ? img_b : img_a) + plane * c * b;
  T* out = (second ? out_b : out_a) + plane_o * c * b + p;
  if constexpr (kU8) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v[PX];
#pragma unroll
      for (int i = 0; i < PX; ++i) v[i] = sample(img + ch * plane, k[i]);
      st2(out + ch * plane_o, v, n, kVec);
    }
  } else {
    int g = blockIdx.y % ngroups;
    int c1 = min(c, (g + 1) * group);
    for (int ch = g * group; ch < c1; ++ch) {
      const T* pl = img + ch * plane;
      float v00 = ldf(pl + k[0].i00), v01 = ldf(pl + k[0].i01);
      float v10 = ldf(pl + k[0].i10), v11 = ldf(pl + k[0].i11);
      out[ch * plane_o] =
          store<T>(feat_sum(v00, v01, v10, v11, k[0].w00, k[0].w01, k[0].w10, k[0].w11));
    }
  }
}

// ---------------------------------------------------------------------------
// K6 and K7
// ---------------------------------------------------------------------------

// K6: out (B,H,3,W) = st*m + wi*(1-m) in T, st and wi the u8-origin warps of
// img_m by flow_m and of img_i by flow_i, each cast to T; 1-m, each product
// and the sum rounded to T.  As K5: two adjacent output pixels a thread
// under the register cap (32 in bf16, 8 blocks of 256 threads an SM; 40 in
// f32), tile_w x tile_h pixels a block; kVec (W even, flows, mask and output
// aligned to two elements): 2-element loads of both flows and the mask and
// 2-element stores into each plane row; otherwise scalar, and a second pixel
// past the right edge (odd W) reads flow 0, gathers at clamped corners and
// is not stored.  Pixel-major: both warps of pixel x, then both of x+1, so
// one warp's corners are live at a time (computing warp m's planes for both
// pixels first, then warp i's, as the Pallas kernel orders it, spilled
// ~128 B a thread at the cap and took 0.44 ms against 0.25 on an H100 at
// B=8 1088x1920 bf16).
template <typename T, bool kVec>
__global__ void __launch_bounds__(256, sizeof(T) == 2 ? 8 : 6) warp_render_kernel(
    const T* __restrict__ img_m, const T* __restrict__ flow_m, const T* __restrict__ img_i,
    const T* __restrict__ flow_i, const T* __restrict__ mask, T* __restrict__ out, int h,
    int w) {
  const int x = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (y >= h || x >= w) return;
  const int n = kVec ? 2 : min(2, w - x);
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(y) * w + x;
  const T* fm = flow_m + 2 * plane * b + p;
  const T* fi = flow_i + 2 * plane * b + p;
  const float2 mx = ld2(fm, n, kVec), my = ld2(fm + plane, n, kVec);
  const float2 ix = ld2(fi, n, kVec), iy = ld2(fi + plane, n, kVec);
  const float2 m = ld2(mask + plane * b + p, n, kVec);
  const T* sm = img_m + 3 * plane * b;
  const T* si = img_i + 3 * plane * b;
  const float yf = static_cast<float>(y);
  float o[3][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float xf = static_cast<float>(x + i);
    float st[3];
    {
      const Corners k =
          corners(__fadd_rn(xf, i ? mx.y : mx.x), __fadd_rn(yf, i ? my.y : my.x), h, w);
#pragma unroll
      for (int c = 0; c < 3; ++c) st[c] = q<T>(sample(sm + c * plane, k));
    }
    const Corners k =
        corners(__fadd_rn(xf, i ? ix.y : ix.x), __fadd_rn(yf, i ? iy.y : iy.x), h, w);
    const float mm = i ? m.y : m.x;
    const float om = q<T>(__fsub_rn(1.0f, mm));
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c][i] = __fadd_rn(q<T>(__fmul_rn(st[c], mm)),
                          q<T>(__fmul_rn(q<T>(sample(si + c * plane, k)), om)));
  }
  T* dst = out + (static_cast<size_t>(b) * h + y) * 3 * w + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) st2(dst + c * w, o[c], n, kVec);
}

// K7: output pixel (i, j) of the 1/4-resolution grid averages the u8-origin
// warps at its four taps (4i+1+ty, 4j+1+tx), each sampled at tap + flow(tap)
// and cast to T: 0.5/0.5 over rows (ty), then over columns (tx), in T.  A
// thread an output, kBx x kBy outputs a block, all four taps' corners
// live: the 48 gathers it issues at once keep more loads in flight than the
// designs with more threads and fewer registers measured (a thread a tap,
// the taps summed across lanes by warp shuffles, under the 32-register cap:
// 0.1195 ms against 0.1085 on an H100 at B=8 1088x1920 bf16; a thread an
// output walking its taps one at a time under the same cap: 0.134).  The
// launch bound allows 64 registers (4 blocks of 256 threads an SM).
template <typename T>
__global__ void __launch_bounds__(256, 4) warp_ds4_pair_kernel(
    const T* __restrict__ img_a, const T* __restrict__ flow_a, const T* __restrict__ img_b,
    const T* __restrict__ flow_b, T* __restrict__ out_a, T* __restrict__ out_b, int h, int w) {
  const int ho = h >> 2, wo = w >> 2;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= wo || i >= ho) return;
  const int b = blockIdx.z >> 1;
  const bool second = blockIdx.z & 1;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t plane_o = static_cast<size_t>(ho) * wo;
  const T* img = (second ? img_b : img_a) + 3 * plane * b;
  const T* flow = (second ? flow_b : flow_a) + 2 * plane * b;
  Corners k[2][2];
#pragma unroll
  for (int ty = 0; ty < 2; ++ty)
#pragma unroll
    for (int tx = 0; tx < 2; ++tx)
      k[ty][tx] = flow_corners(flow, plane, 4 * j + 1 + tx, 4 * i + 1 + ty, h, w);
  T* out = (second ? out_b : out_a) + 3 * plane_o * b + static_cast<size_t>(i) * wo + j;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T* src = img + c * plane;
    float col[2];
#pragma unroll
    for (int tx = 0; tx < 2; ++tx) {
      const float y0 = q<T>(sample(src, k[0][tx]));
      const float y1 = q<T>(sample(src, k[1][tx]));
      col[tx] = q<T>(__fadd_rn(q<T>(__fmul_rn(y0, 0.5f)), q<T>(__fmul_rn(y1, 0.5f))));
    }
    out[c * plane_o] =
        store<T>(__fadd_rn(q<T>(__fmul_rn(col[0], 0.5f)), q<T>(__fmul_rn(col[1], 0.5f))));
  }
}

// K3: output pixel (m, n) of the 1/2-resolution grid averages the warps of the
// four full-resolution pixels (2m+pi, 2n+pj), each sampled at pixel +
// flow(pixel) and cast to the storage dtype; per column pj the rows average
// 0.5/0.5 (u_pj), then the two columns, in that dtype.  A thread an output
// under a 32-register bound (8 blocks of 256 threads an SM), kDs2Bx x kDs2By
// outputs a block.  It walks the phases column by column, (0,0), (1,0), then
// (0,1), (1,1), with one phase's corners live at a time (12 gathers in flight)
// and u_pj kept for the three channels, so it fits the bound.  kVec: the flows of the phase pair
// (2n, 2n+1) of each row are one 2-element load (W is even, so they are
// aligned wherever the flow is); otherwise the same kernel loads them one by
// one.  The other designs tried and their times are in PERF.md section 6.
template <typename T, bool kVec>
__global__ void __launch_bounds__(256, 8)
    warp_ds2_kernel(const T* __restrict__ img, const T* __restrict__ flow, T* __restrict__ out,
                    int h, int w) {
  const int ho = h >> 1, wo = w >> 1;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y * blockDim.y + threadIdx.y;
  if (n >= wo || m >= ho) return;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t plane_o = static_cast<size_t>(ho) * wo;
  const T* src = img + 3 * plane * b;
  const T* fl = flow + 2 * plane * b;
  float2 fx[2], fy[2];
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const size_t p = static_cast<size_t>(2 * m + pi) * w + 2 * n;
    fx[pi] = ld2(fl + p, 2, kVec);
    fy[pi] = ld2(fl + plane + p, 2, kVec);
  }
  float u[2][3];
#pragma unroll
  for (int pj = 0; pj < 2; ++pj) {
    float top[3];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const Corners k =
          corners(__fadd_rn(static_cast<float>(2 * n + pj), pj ? fx[pi].y : fx[pi].x),
                  __fadd_rn(static_cast<float>(2 * m + pi), pj ? fy[pi].y : fy[pi].x), h, w);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = q<T>(sample(src + c * plane, k));
        if (pi == 0)
          top[c] = v;
        else
          u[pj][c] = q<T>(__fadd_rn(q<T>(__fmul_rn(top[c], 0.5f)), q<T>(__fmul_rn(v, 0.5f))));
      }
    }
  }
  T* dst = out + 3 * plane_o * b + static_cast<size_t>(m) * wo + n;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dst[c * plane_o] = store<T>(
        __fadd_rn(q<T>(__fmul_rn(u[0][c], 0.5f)), q<T>(__fmul_rn(u[1][c], 0.5f))));
}

// S: output pixel (x, y) of a shard's rows [row0, row0 + rows) samples the
// whole source (h rows) at (x + fx, (row0 + y) + fy), the flow (B,2,rows,W)
// read at the shard's own row y; u8 mode (C == 3) the u8-origin sum scaled by
// 1/255, float mode the float warp's sum, both cast once to T.  kDs4: output
// (i, j) of the 1/4 grid averages the casts of its four taps (4i+1+ty,
// 4j+1+tx), 0.5/0.5 over rows then columns in T (half_sum2's order, K7's
// epilogue).  Float mode: the block's `group` channels of blockIdx.y's group.
template <typename T, bool kU8, bool kDs4>
__global__ void __launch_bounds__(256, kDs4 ? 3 : 6) warp_spatial_kernel(
    const T* __restrict__ img, const T* __restrict__ flow, T* __restrict__ out, int c,
    int group, int ngroups, int h, int w, int rows, int row0) {
  const int ho = kDs4 ? rows >> 2 : rows, wo = kDs4 ? w >> 2 : w;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = (blockIdx.y / ngroups) * blockDim.y + threadIdx.y;
  if (x >= wo || y >= ho) return;
  const int b = blockIdx.z;
  const int c0 = kU8 ? 0 : (blockIdx.y % ngroups) * group;
  const int c1 = kU8 ? 3 : min(c, c0 + group);
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t fplane = static_cast<size_t>(rows) * w;
  const size_t plane_o = static_cast<size_t>(ho) * wo;
  const T* src = img + plane * c * b;
  const T* fl = flow + 2 * fplane * b;
  T* dst = out + plane_o * c * b + static_cast<size_t>(y) * wo + x;
  if constexpr (!kDs4) {
    const size_t p = static_cast<size_t>(y) * w + x;
    const Corners k = corners(__fadd_rn(static_cast<float>(x), ldf(fl + p)),
                              __fadd_rn(static_cast<float>(row0 + y), ldf(fl + fplane + p)),
                              h, w);
    for (int ch = c0; ch < c1; ++ch) {
      const T* pl = src + ch * plane;
      float v;
      if constexpr (kU8) {
        v = sample(pl, k);
      } else {
        v = feat_sum(ldf(pl + k.i00), ldf(pl + k.i01), ldf(pl + k.i10), ldf(pl + k.i11), k.w00,
                     k.w01, k.w10, k.w11);
      }
      dst[ch * plane_o] = store<T>(v);
    }
  } else {
    Corners k[2][2];
#pragma unroll
    for (int ty = 0; ty < 2; ++ty)
#pragma unroll
      for (int tx = 0; tx < 2; ++tx) {
        const int ly = 4 * y + 1 + ty, lx = 4 * x + 1 + tx;
        const size_t p = static_cast<size_t>(ly) * w + lx;
        k[ty][tx] = corners(__fadd_rn(static_cast<float>(lx), ldf(fl + p)),
                            __fadd_rn(static_cast<float>(row0 + ly), ldf(fl + fplane + p)), h,
                            w);
      }
    for (int ch = c0; ch < c1; ++ch) {
      const T* pl = src + ch * plane;
      float col[2];
#pragma unroll
      for (int tx = 0; tx < 2; ++tx) {
        float v[2];
#pragma unroll
        for (int ty = 0; ty < 2; ++ty) {
          const Corners& kk = k[ty][tx];
          if constexpr (kU8) {
            v[ty] = q<T>(sample(pl, kk));
          } else {
            v[ty] = q<T>(feat_sum(ldf(pl + kk.i00), ldf(pl + kk.i01), ldf(pl + kk.i10),
                                  ldf(pl + kk.i11), kk.w00, kk.w01, kk.w10, kk.w11));
          }
        }
        col[tx] = q<T>(__fadd_rn(q<T>(__fmul_rn(v[0], 0.5f)), q<T>(__fmul_rn(v[1], 0.5f))));
      }
      dst[ch * plane_o] =
          store<T>(__fadd_rn(q<T>(__fmul_rn(col[0], 0.5f)), q<T>(__fmul_rn(col[1], 0.5f))));
    }
  }
}

constexpr int kBx = 32, kBy = 8;      // K7's and S's block of outputs
constexpr int kDs2Bx = 32, kDs2By = 4;  // K3's block of 1/2-resolution outputs

inline dim3 grid_for(int w, int h, int z) {
  return dim3((w + kBx - 1) / kBx, (h + kBy - 1) / kBy, z);
}

inline bool aligned(const void* p, size_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// one launch's operands: images, flows/positions and outputs of image a and
// (pair != 0) image b; `group` channels a block in float mode; a block's
// tile of tile_w x tile_h output pixels
struct Launch {
  const void *img_a, *pos_a;
  void* out_a;
  const void *img_b, *pos_b;
  void* out_b;
  int pair, batch, c, h, w, ho, wo, group, tile_w, tile_h;
  cudaStream_t s;
};

// a tile of whole warps of at most 256 threads (the launch bound), px
// output pixels a thread
inline bool tile_ok(int tile_w, int tile_h, int px) {
  int threads = tile_w / px * tile_h;
  return tile_w % px == 0 && tile_h >= 1 && threads > 0 && threads % 32 == 0 &&
         threads <= 256;
}

template <typename T, typename P, bool kAbs, bool kU8, bool kVec>
void launch_gather(const Launch& a) {
  constexpr int PX = kU8 ? 2 : 1;
  int ngroups = kU8 ? 1 : (a.c + a.group - 1) / a.group;
  dim3 grid((a.wo + a.tile_w - 1) / a.tile_w, ((a.ho + a.tile_h - 1) / a.tile_h) * ngroups,
            a.pair ? 2 * a.batch : a.batch);
  warp_gather_kernel<T, P, kAbs, kU8, kVec><<<grid, dim3(a.tile_w / PX, a.tile_h), 0, a.s>>>(
      static_cast<const T*>(a.img_a), static_cast<const P*>(a.pos_a), static_cast<T*>(a.out_a),
      static_cast<const T*>(a.img_b), static_cast<const P*>(a.pos_b), static_cast<T*>(a.out_b),
      a.pair, a.c, a.group, ngroups, a.h, a.w, a.ho, a.wo);
}

// One launch of K1/K2 (kU8 false) or K4/K5 (kU8 true; pair != 0: K5); the
// u8 modes take the vector path where Wo is even and every flow/position and
// output is aligned to two elements.
template <typename T, typename P, bool kAbs, bool kU8>
void launch_warp(const Launch& a) {
  if constexpr (kU8) {
    if (a.wo % 2 == 0 && aligned(a.pos_a, 2 * sizeof(P)) && aligned(a.pos_b, 2 * sizeof(P)) &&
        aligned(a.out_a, 2 * sizeof(T)) && aligned(a.out_b, 2 * sizeof(T))) {
      launch_gather<T, P, kAbs, true, true>(a);
      return;
    }
  }
  launch_gather<T, P, kAbs, kU8, false>(a);
}

template <typename T, typename P, bool kAbs>
void launch_single(const Launch& a, int u8) {
  if (u8)
    launch_warp<T, P, kAbs, true>(a);
  else
    launch_warp<T, P, kAbs, false>(a);
}

template <typename T, bool kVec>
void render_as(dim3 grid, dim3 block, cudaStream_t s, const void* img_m, const void* flow_m,
               const void* img_i, const void* flow_i, const void* mask, void* out, int h,
               int w) {
  warp_render_kernel<T, kVec><<<grid, block, 0, s>>>(
      static_cast<const T*>(img_m), static_cast<const T*>(flow_m), static_cast<const T*>(img_i),
      static_cast<const T*>(flow_i), static_cast<const T*>(mask), static_cast<T*>(out), h, w);
}

// K6; the vector path where W is even and both flows, the mask and the
// output are aligned to two elements
template <typename T>
void launch_render(const void* img_m, const void* flow_m, const void* img_i, const void* flow_i,
                   const void* mask, void* out, int batch, int h, int w, int tile_w, int tile_h,
                   cudaStream_t s) {
  dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, batch);
  dim3 block(tile_w / 2, tile_h);
  constexpr size_t a2 = 2 * sizeof(T);
  if (w % 2 == 0 && aligned(flow_m, a2) && aligned(flow_i, a2) && aligned(mask, a2) &&
      aligned(out, a2))
    render_as<T, true>(grid, block, s, img_m, flow_m, img_i, flow_i, mask, out, h, w);
  else
    render_as<T, false>(grid, block, s, img_m, flow_m, img_i, flow_i, mask, out, h, w);
}

// K3; the vector flow loads where the flow is aligned to two elements
template <typename T>
void launch_ds2(dim3 grid, cudaStream_t s, const void* img, const void* flow, void* out, int h,
                int w) {
  const dim3 block(kDs2Bx, kDs2By);
  const T* i = static_cast<const T*>(img);
  const T* f = static_cast<const T*>(flow);
  T* o = static_cast<T*>(out);
  if (aligned(flow, 2 * sizeof(T)))
    warp_ds2_kernel<T, true><<<grid, block, 0, s>>>(i, f, o, h, w);
  else
    warp_ds2_kernel<T, false><<<grid, block, 0, s>>>(i, f, o, h, w);
}

}  // namespace

// C interface.  All tensors are contiguous NCHW in one dtype (bf16 != 0 ->
// __nv_bfloat16, else float); images (B,3,H,W), flows (B,2,H,W), mask (B,H,W).
// Each returns cudaGetLastError() right after its launch.
extern "C" {

// K5.  tile_w x tile_h: a block's tile of output pixels, two a thread, in
// whole warps of at most 256 threads.
int rife_warp_pair(const void* img_a, const void* flow_a, const void* img_b,
                   const void* flow_b, void* out_a, void* out_b, int batch, int h, int w,
                   int bf16, int tile_w, int tile_h, void* stream) {
  if (!tile_ok(tile_w, tile_h, 2)) return static_cast<int>(cudaErrorInvalidValue);
  Launch a{img_a, flow_a, out_a, img_b, flow_b, out_b, 1, batch, 3, h, w, h, w, 3,
           tile_w, tile_h, static_cast<cudaStream_t>(stream)};
  if (bf16)
    launch_warp<__nv_bfloat16, __nv_bfloat16, false, true>(a);
  else
    launch_warp<float, float, false, true>(a);
  return static_cast<int>(cudaGetLastError());
}

// K6.  mask (B,H,W), out (B,H,3,W); tile_w x tile_h as for rife_warp_pair.
int rife_warp_render(const void* img_m, const void* flow_m, const void* img_i,
                     const void* flow_i, const void* mask, void* out, int batch, int h, int w,
                     int bf16, int tile_w, int tile_h, void* stream) {
  if (!tile_ok(tile_w, tile_h, 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_render<__nv_bfloat16>(img_m, flow_m, img_i, flow_i, mask, out, batch, h, w, tile_w,
                                 tile_h, s);
  else
    launch_render<float>(img_m, flow_m, img_i, flow_i, mask, out, batch, h, w, tile_w, tile_h, s);
  return static_cast<int>(cudaGetLastError());
}

// K7.  H and W divisible by 4; out_a, out_b (B,3,H/4,W/4).
int rife_warp_ds4_pair(const void* img_a, const void* flow_a, const void* img_b,
                       const void* flow_b, void* out_a, void* out_b, int batch, int h, int w,
                       int bf16, void* stream) {
  if ((h | w) & 3) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid = grid_for(w / 4, h / 4, 2 * batch), block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    warp_ds4_pair_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(img_a), static_cast<const T*>(flow_a),
        static_cast<const T*>(img_b), static_cast<const T*>(flow_b), static_cast<T*>(out_a),
        static_cast<T*>(out_b), h, w);
  } else {
    using T = float;
    warp_ds4_pair_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(img_a), static_cast<const T*>(flow_a),
        static_cast<const T*>(img_b), static_cast<const T*>(flow_b), static_cast<T*>(out_a),
        static_cast<T*>(out_b), h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3.  img (B,3,H,W), flow (B,2,H,W), out (B,3,H/2,W/2); H and W even.
int rife_warp_ds2(const void* img, const void* flow, void* out, int batch, int h, int w,
                  int bf16, void* stream) {
  if ((h | w) & 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((w / 2 + kDs2Bx - 1) / kDs2Bx, (h / 2 + kDs2By - 1) / kDs2By, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_ds2<__nv_bfloat16>(grid, s, img, flow, out, h, w);
  else
    launch_ds2<float>(grid, s, img, flow, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

// img (B,C,H,W); pos a raw flow (B,2,H,W) in the image dtype (abs_pos == 0,
// then Ho == H, Wo == W) or float32 absolute positions (B,2,Ho,Wo); out
// (B,C,Ho,Wo).  u8 != 0 samples round(clip(v,0,1)*255) and scales by 1/255
// (K4; C == 3; two output pixels a thread); else the float mode (K1/K2; one
// pixel a thread, `group` channels a block).  tile_w x tile_h as for
// rife_warp_pair.
int rife_warp_single(const void* img, const void* pos, void* out, int batch, int c, int h,
                     int w, int ho, int wo, int abs_pos, int u8, int bf16, int tile_w,
                     int tile_h, int group, void* stream) {
  if ((!abs_pos && (ho != h || wo != w)) || (u8 && c != 3) || group < 1 ||
      !tile_ok(tile_w, tile_h, u8 ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{img, pos, out, img, pos, out, 0, batch, c, h, w, ho, wo, u8 ? 3 : group,
           tile_w, tile_h, static_cast<cudaStream_t>(stream)};
  using B = __nv_bfloat16;
  if (bf16 && abs_pos)
    launch_single<B, float, true>(a, u8);
  else if (bf16)
    launch_single<B, B, false>(a, u8);
  else if (abs_pos)
    launch_single<float, float, true>(a, u8);
  else
    launch_single<float, float, false>(a, u8);
  return static_cast<int>(cudaGetLastError());
}

// S.  img (B,C,H,W) the whole source; flow (B,2,rows,W) the shard's rows of
// the raw flow, in the image dtype; row0 the global row of its first row
// (0 <= row0, row0 + rows <= H); out (B,C,rows,W), or with ds4 != 0
// (B,C,rows/4,W/4) (rows and W divisible by 4).  u8 != 0: C == 3, the
// u8-origin sampling; else the float warp, `group` channels a block.
int rife_warp_spatial(const void* img, const void* flow, void* out, int batch, int c, int h,
                      int w, int rows, int row0, int u8, int ds4, int bf16, int group,
                      void* stream) {
  if (batch < 1 || c < 1 || rows < 1 || row0 < 0 || row0 + rows > h || (u8 && c != 3) ||
      group < 1 || (ds4 && ((rows | w) & 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = ds4 ? rows / 4 : rows, wo = ds4 ? w / 4 : w;
  const int ngroups = u8 ? 1 : (c + group - 1) / group;
  const dim3 grid((wo + kBx - 1) / kBx, ((ho + kBy - 1) / kBy) * ngroups, batch);
  const dim3 block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
#define RIFE_SPATIAL(T, U, D)                                                                \
  warp_spatial_kernel<T, U, D><<<grid, block, 0, s>>>(                                       \
      static_cast<const T*>(img), static_cast<const T*>(flow), static_cast<T*>(out), c, group, \
      ngroups, h, w, rows, row0)
  if (bf16) {
    if (u8) {
      if (ds4) RIFE_SPATIAL(B, true, true); else RIFE_SPATIAL(B, true, false);
    } else {
      if (ds4) RIFE_SPATIAL(B, false, true); else RIFE_SPATIAL(B, false, false);
    }
  } else {
    if (u8) {
      if (ds4) RIFE_SPATIAL(float, true, true); else RIFE_SPATIAL(float, true, false);
    } else {
      if (ds4) RIFE_SPATIAL(float, false, true); else RIFE_SPATIAL(float, false, false);
    }
  }
#undef RIFE_SPATIAL
  return static_cast<int>(cudaGetLastError());
}

const char* rife_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
