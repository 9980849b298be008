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
//
// What bounds them on the H100: a backward warp is a data-dependent gather at
// about 2 FLOP per byte, so memory and latency bound it and the tensor cores
// play no part.  Per output pixel and image a thread reads the 2 flow values
// (4 B in bf16), gathers 4 corners x 3 planes (24 B in bf16, at positions the
// flow decides) and writes 3 values (6 B); the ds4 form gathers 4 taps of that
// per 1/4-resolution pixel.  At 1088x1920, B=8, bf16 that is ~0.7 GB of traffic
// per pair launch, ~0.2 ms at the 3.35 TB/s peak, if the gathers hit.  The ds2
// form gathers as much as a full-resolution warp (the 1/2 downsample reads
// every warped pixel) but writes a quarter of it and no full-resolution
// intermediate: per half-resolution pixel 4 x 4 B of flow, 4 x 12 corner
// gathers and 6 B of output in bf16.
//
// What the design does about it: one thread per output pixel handles every
// channel, so the corner indices and weights are computed once and reused for
// the three planes.  Threads of a warp cover 32 neighbouring x on one row, so
// the flow reads and output writes coalesce, and for smooth flows the corner
// gathers of neighbouring threads fall on the same or adjacent lines and are
// served by L1/L2 (__ldg, read-only path).  None of the TPU machinery carries
// over: no u8-quad lane packing, no band/slab/sheared staging, no VMEM
// stripes -- those exist because a TPU has no gather unit.  The single warp
// keeps that shape for any C: the position, corners and weights are computed
// once per pixel, then a loop over the C planes gathers and writes each
// channel (the channel-shared index of the TPU's mc kernel, without its
// packing of two bf16 channels per word).  A contextnet feature warp at 1080p
// B=16 (C=32, 272x480) reads ~4 B of flow and gathers 4 x 32 x 2 B per pixel.
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

// K5: grid.z = 2*B; even z warps image a, odd z image b, of batch item z/2.
template <typename T>
__global__ void warp_pair_kernel(const T* __restrict__ img_a, const T* __restrict__ flow_a,
                                 const T* __restrict__ img_b, const T* __restrict__ flow_b,
                                 T* __restrict__ out_a, T* __restrict__ out_b, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  int b = blockIdx.z >> 1;
  bool second = blockIdx.z & 1;
  size_t plane = static_cast<size_t>(h) * w;
  const T* img = (second ? img_b : img_a) + 3 * plane * b;
  const T* flow = (second ? flow_b : flow_a) + 2 * plane * b;
  T* out = (second ? out_b : out_a) + 3 * plane * b;
  Corners k = flow_corners(flow, plane, x, y, h, w);
  size_t p = static_cast<size_t>(y) * w + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * plane + p] = store<T>(sample(img + c * plane, k));
}

// K6: both warps, then o = st*m + wi*(1-m) in the storage dtype; out (B,H,3,W).
template <typename T>
__global__ void warp_render_kernel(const T* __restrict__ img_m, const T* __restrict__ flow_m,
                                   const T* __restrict__ img_i, const T* __restrict__ flow_i,
                                   const T* __restrict__ mask, T* __restrict__ out, int h,
                                   int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  int b = blockIdx.z;
  size_t plane = static_cast<size_t>(h) * w;
  size_t p = static_cast<size_t>(y) * w + x;
  Corners km = flow_corners(flow_m + 2 * plane * b, plane, x, y, h, w);
  Corners ki = flow_corners(flow_i + 2 * plane * b, plane, x, y, h, w);
  float m = ldf(mask + plane * b + p);
  float om = q<T>(__fsub_rn(1.0f, m));
  const T* src_m = img_m + 3 * plane * b;
  const T* src_i = img_i + 3 * plane * b;
  T* dst = out + (static_cast<size_t>(b) * h + y) * 3 * w + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float st = q<T>(sample(src_m + c * plane, km));
    float wi = q<T>(sample(src_i + c * plane, ki));
    float o = __fadd_rn(q<T>(__fmul_rn(st, m)), q<T>(__fmul_rn(wi, om)));
    dst[c * w] = store<T>(o);
  }
}

// K7: output pixel (i, j) of the 1/4-resolution grid averages the warps at the
// four taps (4i+1+ty, 4j+1+tx), each sampled at tap + flow(tap) and cast to the
// storage dtype; 0.5/0.5 over rows first, then over columns, in that dtype.
template <typename T>
__global__ void warp_ds4_pair_kernel(const T* __restrict__ img_a, const T* __restrict__ flow_a,
                                     const T* __restrict__ img_b, const T* __restrict__ flow_b,
                                     T* __restrict__ out_a, T* __restrict__ out_b, int h,
                                     int w) {
  int ho = h >> 2, wo = w >> 2;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= wo || i >= ho) return;
  int b = blockIdx.z >> 1;
  bool second = blockIdx.z & 1;
  size_t plane = static_cast<size_t>(h) * w;
  size_t plane_o = static_cast<size_t>(ho) * wo;
  const T* img = (second ? img_b : img_a) + 3 * plane * b;
  const T* flow = (second ? flow_b : flow_a) + 2 * plane * b;
  T* out = (second ? out_b : out_a) + 3 * plane_o * b;
  Corners k[2][2];
#pragma unroll
  for (int ty = 0; ty < 2; ++ty)
#pragma unroll
    for (int tx = 0; tx < 2; ++tx)
      k[ty][tx] = flow_corners(flow, plane, 4 * j + 1 + tx, 4 * i + 1 + ty, h, w);
  size_t po = static_cast<size_t>(i) * wo + j;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T* src = img + c * plane;
    float col[2];
#pragma unroll
    for (int tx = 0; tx < 2; ++tx) {
      float y0 = q<T>(sample(src, k[0][tx]));
      float y1 = q<T>(sample(src, k[1][tx]));
      col[tx] = q<T>(__fadd_rn(q<T>(__fmul_rn(y0, 0.5f)), q<T>(__fmul_rn(y1, 0.5f))));
    }
    out[c * plane_o + po] =
        store<T>(__fadd_rn(q<T>(__fmul_rn(col[0], 0.5f)), q<T>(__fmul_rn(col[1], 0.5f))));
  }
}

// K3: output pixel (m, n) of the 1/2-resolution grid averages the warps of the
// four full-resolution pixels (2m+pi, 2n+pj), phase p = 2*pi + pj, each sampled
// at pixel + flow(pixel) and cast to the storage dtype; then v0/2 + v2/2 and
// v1/2 + v3/2 (rows), then their 0.5/0.5 average (columns), in that dtype.
// None of the Pallas kernel's machinery carries over: no u8-quad words, no
// slabs, no per-(band, window) ranges, no phase de-interleaved operands -- the
// thread reads the four phase positions' flow itself and gathers directly.
template <typename T>
__global__ void warp_ds2_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                                T* __restrict__ out, int h, int w) {
  int ho = h >> 1, wo = w >> 1;
  int n = blockIdx.x * blockDim.x + threadIdx.x;
  int m = blockIdx.y * blockDim.y + threadIdx.y;
  if (n >= wo || m >= ho) return;
  int b = blockIdx.z;
  size_t plane = static_cast<size_t>(h) * w;
  size_t plane_o = static_cast<size_t>(ho) * wo;
  const T* src = img + 3 * plane * b;
  const T* fl = flow + 2 * plane * b;
  Corners k[4];
#pragma unroll
  for (int pi = 0; pi < 2; ++pi)
#pragma unroll
    for (int pj = 0; pj < 2; ++pj)
      k[2 * pi + pj] = flow_corners(fl, plane, 2 * n + pj, 2 * m + pi, h, w);
  T* dst = out + 3 * plane_o * b + static_cast<size_t>(m) * wo + n;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T* s = src + c * plane;
    float v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) v[p] = q<T>(sample(s, k[p]));
    float u0 = q<T>(__fadd_rn(q<T>(__fmul_rn(v[0], 0.5f)), q<T>(__fmul_rn(v[2], 0.5f))));
    float u1 = q<T>(__fadd_rn(q<T>(__fmul_rn(v[1], 0.5f)), q<T>(__fmul_rn(v[3], 0.5f))));
    dst[c * plane_o] =
        store<T>(__fadd_rn(q<T>(__fmul_rn(u0, 0.5f)), q<T>(__fmul_rn(u1, 0.5f))));
  }
}

// K1/K2: ((v00*w00 + v01*w01) + v10*w10) + v11*w11 in f32 -- the Pallas
// kernels' order where the four corners fall in one lane tile
template <typename T>
__device__ __forceinline__ float sample_feat(const T* plane, const Corners& k) {
  float acc = __fmul_rn(ldf(plane + k.i00), k.w00);
  acc = __fadd_rn(acc, __fmul_rn(ldf(plane + k.i01), k.w01));
  acc = __fadd_rn(acc, __fmul_rn(ldf(plane + k.i10), k.w10));
  return __fadd_rn(acc, __fmul_rn(ldf(plane + k.i11), k.w11));
}

// K1/K2/K4: one warp of a (B,C,H,W) image.  Output pixel (x, y) of the
// (Ho,Wo) grid samples at (x, y) + flow(x, y) (flow of type P = T), or at the
// absolute position pos(x, y) (P = float); one cast to T per channel.
template <typename T, typename P, bool kAbs, bool kU8>
__global__ void warp_single_kernel(const T* __restrict__ img, const P* __restrict__ pos,
                                   T* __restrict__ out, int c, int h, int w, int ho,
                                   int wo) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= wo || y >= ho) return;
  int b = blockIdx.z;
  size_t plane_o = static_cast<size_t>(ho) * wo;
  size_t plane = static_cast<size_t>(h) * w;
  size_t p = static_cast<size_t>(y) * wo + x;
  const P* pb = pos + 2 * plane_o * b;
  float sx = ldf(pb + p), sy = ldf(pb + plane_o + p);
  if (!kAbs) {
    sx = __fadd_rn(static_cast<float>(x), sx);
    sy = __fadd_rn(static_cast<float>(y), sy);
  }
  Corners k = corners(sx, sy, h, w);
  const T* src = img + plane * c * b;
  T* dst = out + plane_o * c * b + p;
  for (int ch = 0; ch < c; ++ch) {
    const T* pl = src + plane * ch;
    float v = kU8 ? sample(pl, k) : sample_feat(pl, k);
    dst[plane_o * ch] = store<T>(v);
  }
}

constexpr int kBx = 32, kBy = 8;

inline dim3 grid_for(int w, int h, int z) {
  return dim3((w + kBx - 1) / kBx, (h + kBy - 1) / kBy, z);
}

template <typename T, bool kU8>
void launch_single(const void* img, const void* pos, void* out, int batch, int c, int h,
                   int w, int ho, int wo, int abs_pos, cudaStream_t s) {
  dim3 grid = grid_for(wo, ho, batch), block(kBx, kBy);
  if (abs_pos) {
    warp_single_kernel<T, float, true, kU8><<<grid, block, 0, s>>>(
        static_cast<const T*>(img), static_cast<const float*>(pos), static_cast<T*>(out),
        c, h, w, ho, wo);
  } else {
    warp_single_kernel<T, T, false, kU8><<<grid, block, 0, s>>>(
        static_cast<const T*>(img), static_cast<const T*>(pos), static_cast<T*>(out), c,
        h, w, ho, wo);
  }
}

}  // namespace

// C interface.  All tensors are contiguous NCHW in one dtype (bf16 != 0 ->
// __nv_bfloat16, else float); images (B,3,H,W), flows (B,2,H,W), mask (B,H,W).
// Each returns cudaGetLastError() right after its launch.
extern "C" {

int rife_warp_pair(const void* img_a, const void* flow_a, const void* img_b,
                   const void* flow_b, void* out_a, void* out_b, int batch, int h, int w,
                   int bf16, void* stream) {
  dim3 grid = grid_for(w, h, 2 * batch), block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    warp_pair_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(img_a), static_cast<const T*>(flow_a),
        static_cast<const T*>(img_b), static_cast<const T*>(flow_b), static_cast<T*>(out_a),
        static_cast<T*>(out_b), h, w);
  } else {
    using T = float;
    warp_pair_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(img_a), static_cast<const T*>(flow_a),
        static_cast<const T*>(img_b), static_cast<const T*>(flow_b), static_cast<T*>(out_a),
        static_cast<T*>(out_b), h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int rife_warp_render(const void* img_m, const void* flow_m, const void* img_i,
                     const void* flow_i, const void* mask, void* out, int batch, int h, int w,
                     int bf16, void* stream) {
  dim3 grid = grid_for(w, h, batch), block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    warp_render_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(img_m), static_cast<const T*>(flow_m),
        static_cast<const T*>(img_i), static_cast<const T*>(flow_i),
        static_cast<const T*>(mask), static_cast<T*>(out), h, w);
  } else {
    using T = float;
    warp_render_kernel<T><<<grid, block, 0, s>>>(
        static_cast<const T*>(img_m), static_cast<const T*>(flow_m),
        static_cast<const T*>(img_i), static_cast<const T*>(flow_i),
        static_cast<const T*>(mask), static_cast<T*>(out), h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int rife_warp_ds4_pair(const void* img_a, const void* flow_a, const void* img_b,
                       const void* flow_b, void* out_a, void* out_b, int batch, int h, int w,
                       int bf16, void* stream) {
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

// img (B,3,H,W), flow (B,2,H,W), out (B,3,H/2,W/2); H and W even.
int rife_warp_ds2(const void* img, const void* flow, void* out, int batch, int h, int w,
                  int bf16, void* stream) {
  if ((h | w) & 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid = grid_for(w / 2, h / 2, batch), block(kBx, kBy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    warp_ds2_kernel<T><<<grid, block, 0, s>>>(static_cast<const T*>(img),
                                              static_cast<const T*>(flow), static_cast<T*>(out),
                                              h, w);
  } else {
    using T = float;
    warp_ds2_kernel<T><<<grid, block, 0, s>>>(static_cast<const T*>(img),
                                              static_cast<const T*>(flow), static_cast<T*>(out),
                                              h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// img (B,C,H,W); pos a raw flow (B,2,H,W) in the image dtype (abs_pos == 0,
// then Ho == H, Wo == W) or float32 absolute positions (B,2,Ho,Wo); out
// (B,C,Ho,Wo).  u8 != 0 samples round(clip(v,0,1)*255) and scales by 1/255
// (K4; C == 3).
int rife_warp_single(const void* img, const void* pos, void* out, int batch, int c, int h,
                     int w, int ho, int wo, int abs_pos, int u8, int bf16, void* stream) {
  if (!abs_pos && (ho != h || wo != w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (u8) launch_single<__nv_bfloat16, true>(img, pos, out, batch, c, h, w, ho, wo, abs_pos, s);
    else launch_single<__nv_bfloat16, false>(img, pos, out, batch, c, h, w, ho, wo, abs_pos, s);
  } else {
    if (u8) launch_single<float, true>(img, pos, out, batch, c, h, w, ho, wo, abs_pos, s);
    else launch_single<float, false>(img, pos, out, batch, c, h, w, ho, wo, abs_pos, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rife_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
