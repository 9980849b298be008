// Hand-written Hopper (sm_90a) kernels for the planar conv sites of the
// v2.3 and v1 paths: a 3x3 pad-1 conv, stride 1 or 2, over the channel concat of
// 1-4 input parts (the concat is never built), f32 accumulation, the f32
// bias and the activation (none, ReLU, leaky, per-channel PReLU) in f32 and
// one rounding to the storage dtype.
// In f32 a deconv site (4x4 stride-2 transposed conv) runs on the f32
// kernel's deconv mode; in bf16 it takes csrc/deconv.cu.  Plain C
// interface, loaded with ctypes by rife_tpu_torch/native/build.py; the
// PyTorch wrapper, the plain twins, the weight packing and the site gates are
// in rife_tpu_torch/ops/conv.py.
//
// Replaces (rife_tpu/ops/conv_planar.py):
//   stride 1  _conv_planar_s1_direct -> _conv_s1_direct_kernel (K11; also the
//             base of deconv_planar); conv_planar_bhcw -> _conv_planar_kernel
//             (K9) computes the same
//   stride 2  _conv_planar_s2_direct_cat / _conv_planar_s2_direct ->
//             _conv_s2_direct_kernel (K12); conv_s2_bhcw -> _conv_s2_kernel
//             (K10) computes the same
//   (B4's conv form, conv_ps_planar, is csrc/conv_ps.cu's kernel and its
//   deconv form, deconv_ps_planar, csrc/deconv.cu's)
//
// bf16, the main path: conv3x3_tc_kernel, an implicit GEMM on the tensor
// cores (mma.sync.m16n8k16, bf16 in, f32 accumulate).
//
// What bounds it on the H100: the 11 sites of a 1080p B=8 v2.3 step are
// narrow (Cin 3-192, Cout 16-96) at up to full resolution.  They move
// 5.77 GB (bf16 in and out, each byte once) and do 241 GMAC: 1.72 ms at
// 3.35 TB/s, against 0.49 ms of tensor-core work at 989 TFLOP/s; ~83 FLOP a
// byte, below the card's ~295.  So memory bounds it, provided the MMAs are
// fed at ~280 TFLOP/s, which mma.sync reaches; wgmma's 64-row tiles and
// descriptors buy nothing until the kernel sits at the memory bound.
//
// What the design does about it:
// - GEMM shape: M = 16 output pixels of one output row per m16 tile, N = a
//   group of output channels (up to 64: NT n8 tiles, a whole site's Cout in
//   one block up to 64, two groups above), K = Cin padded to 16, x 9 taps.
//   8 warps; at stride 1 a block computes 16 rows x 16 columns (2 rows a
//   warp), at stride 2 8 x 16 (1 row a warp).  (Tiles 4 rows x 64 columns
//   wide, for longer runs along x in NCHW, measured no faster.)
// - Weights stay in shared memory for the whole block as [tap][co][ci
//   padded + 8 skew] bf16, packed once per model on the host (weight_tc,
//   ops/conv.py pack_weight_tc); blocks are persistent (as many as fit on
//   the SMs) and walk the output tiles, so each loads its weights once.
// - The input tile with its halo is staged channels innermost, [row][col]
//   [16 channels + skew], one 16-channel chunk at a time: a 3x3 tap is a
//   shift of the pixel address (stride 2 a stride in it), the A fragments
//   are 32-bit loads of a pixel's channel pairs, and the skews (24 elements
//   a pixel at stride 1, 20 at stride 2, cp+8 a weight row) make every
//   fragment load free of bank conflicts.  Each stage channel resolves to
//   its part's plane, so ConvolutionCat never builds the concat.
// - The next chunk (of this tile or the next) is loaded into registers as
//   8-byte vectors along x (scalar loads where W % 4 or the alignment does
//   not allow them) while the current chunk's MMAs run, then transposed
//   into the other of two shared buffers: one __syncthreads per chunk.
// - Epilogue: f32 bias and activation with _rn products, one rounding;
//   the group's bias and negative-side factors sit in shared memory (read
//   from global memory per element they were the costliest part of the
//   epilogue); each warp stages its output row through shared memory and
//   writes 16-byte vectors along x in NCHW.
//
// f32 (RIFE(..., dtype=torch.float32), the calibration, the smoke's
// fidelity checks): conv3x3_f32_kernel on the FP32 pipes (TF32 tensor cores
// would change the f32 arithmetic).  It replaces, in f32, the same Pallas
// kernels as above (_conv_planar_s1_direct :309, _conv_planar_s2_direct_cat
// :485, conv_planar_bhcw :97, conv_s2_bhcw :190) and B4's f32 forms
// (conv_ps_planar :756: the conv, then F.pixel_shuffle; deconv_planar :732
// / deconv_ps_planar :784: its deconv mode).
//
// What bounds it on the H100: a v2.3 1080p B=8 step's 11 f32 sites do
// 218.5 GMAC over 11.5 GB of f32 bytes: 6.5 ms at 66.9 TFLOP/s (132 SMs x 128
// lanes x 2 x 1.98 GHz) against 3.4 ms at 3.35 TB/s; the wide sites (32 ->
// 32 and up) are bounded by the FMAs, the 3-channel ones by bytes.  An FMA
// needs one shared-memory word per R x 8 (the window's column) or per 8 x R
// (a weight) FMAs, and every other instruction takes a dispatch slot from
// them, so the design is about feeding the FMAs:
// - a thread computes R output rows x 8 channels (deconv: R rows x 4
//   phases x 4 channels) of one column: each tap's 8 weights are two
//   float4 broadcasts and each of its window values one load a row, for 64
//   FMAs; R makes a tile 16 rows (conv 4 wc, deconv 2 wc);
// - blocks are persistent over the tiles of their channel group and keep
//   the group's weights resident in shared memory where they fit with two
//   stages in half an SM (else each stage carries its chunk's), so two
//   blocks share an SM at <= 128 registers;
// - input channels stream through a ring of two cp.async stages, the next
//   (of this tile or the next) landing while this one's FMAs run: 16-byte
//   copies of rows aligned at the tile's first column - 4 (W % 4 == 0; else
//   4-byte copies), zero-filled outside the frame; chunks split Cin evenly
//   and stage no channel past it;
// - the deconv mode does only the four non-zero taps of each output phase
//   (2.25x fewer FMAs than the phase conv) and stores each phase pair as
//   one float2 of the interleaved output.
// Each output keeps the sum order of the conv3x3_kernel it replaced, so
// the result is bit for bit that kernel's (see conv3x3_f32_kernel).  The
// tile geometry and the launch plan (channel groups, tiles, stages, resident
// weights) are conv_f32_plan.h's, which a host compiler builds too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "conv_f32_plan.h"

namespace {

constexpr int kMaxParts = 4;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kPrelu = 3 };

struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];
};

// The f32 bias (has_bias) and the activation of one sum: ReLU, or leaky
// and PReLU with the negative-side factor k, products rounded once
__device__ __forceinline__ float finish(float v, bool has_bias, float b, int act, float k) {
  if (has_bias) v = __fadd_rn(v, b);
  if (act == kRelu) return fmaxf(v, 0.0f);
  if (act != kNone) return v >= 0.0f ? v : __fmul_rn(v, k);
  return v;
}

// plane of channel c of batch item b in the parts (null past cin)
template <typename T>
__device__ __forceinline__ const T* channel_plane(const Parts& parts, int b, int c,
                                                  size_t plane) {
#pragma unroll
  for (int k = 0; k < kMaxParts; ++k) {
    if (c < parts.ch[k])
      return static_cast<const T*>(parts.ptr[k]) +
             (static_cast<size_t>(b) * parts.ch[k] + c) * plane;
    c -= parts.ch[k];
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

using rife_f32::kGroupCh;
constexpr int kF32Threads = rife_f32::kThreads;

struct F32Args {
  Parts parts;
  const float* weight;  // conv: (9, cout, cp) (pack_weight_tc); deconv: (16, cout, cp)
  const float* bias;    // (cout,), deconv (4 cout,) phase-tiled; or null
  const float* slope;   // as bias, PReLU only
  float* out;
  int cin, cp, h, w, cout, ho, wo, act;
  float alpha;
  int kc, n_chunks;     // channels a stage holds, chunks of the input channels
  int tiles_x, tiles_y, n_tiles;  // the tiles of a channel group (all batch items)
  int vec;              // 16-byte input copies (W % 4 == 0, parts 16-byte aligned)
  int resident;         // a block's weights stay in shared memory for all its tiles
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

using rife_f32::chunk_start;
using rife_f32::stage_in_floats;

// plane of channel c of batch item b in the parts, by selects (indexing the
// parts' arrays with a run-time value would put them in local memory)
__device__ __forceinline__ const float* f32_plane(const Parts& parts, int b, int c,
                                                  size_t plane) {
  const void* p = parts.ptr[0];
  int n = parts.ch[0];
  if (c >= n) {
    c -= n;
    p = parts.ptr[1];
    n = parts.ch[1];
    if (c >= n) {
      c -= n;
      p = parts.ptr[2];
      n = parts.ch[2];
      if (c >= n) {
        c -= n;
        p = parts.ptr[3];
        n = parts.ch[3];
      }
    }
  }
  return static_cast<const float*>(p) + (static_cast<size_t>(b) * n + c) * plane;
}

// Copies of input channels c0 .. c0 + kc - 1 of batch item b, rows iy0 ..
// iy0 + kIh - 1 and columns x0 .. x0 + kIw - 1, zero outside the frame,
// into xs [ci][row][col]: 16-byte copies (each wholly inside or outside the
// frame: W and x0 are multiples of 4) or, a.vec 0, 4-byte ones.
template <int S, int WC, bool DECONV>
__device__ __forceinline__ void stage_input(const F32Args a, int c0, int kc, int b, int iy0,
                                            int x0, float* xs) {
  using Tl = rife_f32::Tile<S, WC, DECONV>;
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  if (a.vec) {
    for (int i = threadIdx.x; i < kc * Tl::kIh * Tl::kVecs; i += kF32Threads) {
      const int row = i / Tl::kVecs, v = i - row * Tl::kVecs;
      const int ci = row / Tl::kIh, gy = iy0 + row - ci * Tl::kIh, gx = x0 + 4 * v;
      const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const float* src = f32_plane(a.parts, b, c0 + ci, plane);
      cp_async16(xs + row * Tl::kIw + 4 * v, ok ? src + static_cast<size_t>(gy) * a.w + gx : src,
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < kc * Tl::kIh * Tl::kIw; i += kF32Threads) {
      const int row = i / Tl::kIw, c = i - row * Tl::kIw;
      const int ci = row / Tl::kIh, gy = iy0 + row - ci * Tl::kIh, gx = x0 + c;
      const bool ok = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const float* src = f32_plane(a.parts, b, c0 + ci, plane);
      cp_async4(xs + i, ok ? src + static_cast<size_t>(gy) * a.w + gx : src, ok);
    }
  }
}

// Copies of the weights of input channels c0 .. c0 + kc - 1 for channel
// group g into ws [ci][row][t], zero past cout: a thread copies the run of
// input channels of one (row, t), t the tile's channel; deconv: t = warp
// group x 16 + phase x 4 + j, channel g x 4 WC + 4 x warp group + j, rows
// the phase's four taps (pack_weight_t4)
template <int S, int WC, bool DECONV>
__device__ __forceinline__ void stage_weights(const F32Args a, int g, int c0, int kc,
                                              float* ws) {
  using Tl = rife_f32::Tile<S, WC, DECONV>;
  for (int q = threadIdx.x; q < Tl::kTaps * Tl::kCt; q += kF32Threads) {
    const int t = q % Tl::kCt, row = q / Tl::kCt;
    int ch, src_row;
    if (DECONV) {
      ch = g * 4 * WC + 4 * (t / kGroupCh) + t % 4;
      src_row = (t % kGroupCh) / 4 * 4 + row;
    } else {
      ch = g * Tl::kCt + t;
      src_row = row;
    }
    const bool ok = ch < a.cout;
    const float* src =
        a.weight + (static_cast<size_t>(src_row) * a.cout + (ok ? ch : 0)) * a.cp + c0;
    float* dst = ws + row * Tl::kCt + t;
    for (int ci = 0; ci < kc; ++ci) cp_async4(dst + ci * Tl::kTaps * Tl::kCt, src + ci, ok);
  }
}

// tile t of this block's channel group
template <int S, int WC, bool DECONV>
__device__ __forceinline__ rife_f32::TileAt tile_at(const F32Args a, int t) {
  return rife_f32::tile_at(t, a.tiles_x, a.tiles_y, rife_f32::Tile<S, WC, DECONV>::kRows);
}

// The copies of stage number it of this block (its tile blockIdx.x + it /
// n_chunks x gridDim.x of the group, chunk it % n_chunks) into xs: the
// input and, unless the weights are resident, the chunk's weights after it
template <int S, int WC, bool DECONV>
__device__ __forceinline__ void stage_at(const F32Args a, int it, int g, int in_floats,
                                         float* xs) {
  const int k = it % a.n_chunks;
  const rife_f32::TileAt at = tile_at<S, WC, DECONV>(a, blockIdx.x + (it / a.n_chunks) * gridDim.x);
  const int c0 = chunk_start(k, a.cin, a.n_chunks);
  const int kc = chunk_start(k + 1, a.cin, a.n_chunks) - c0;
  stage_input<S, WC, DECONV>(a, c0, kc, at.b, at.oy0 * S - 1, at.ox0 * S - 4, xs);
  if (!a.resident) stage_weights<S, WC, DECONV>(a, g, c0, kc, xs + in_floats);
}

// The f32 conv3x3 (and, DECONV, the 4x4 stride-2 transposed conv as four
// output phases of a 3x3 window, each over its four non-zero taps).  Each
// output's sum is one fmaf chain from +0 over the input channels ascending
// and, within one, the taps (ky, kx) ascending: the order of the kernel it
// replaced, so the result is bit for bit that kernel's (a phase's zero taps
// and the zero halo add +-0, which leaves a sum that starts at +0 as it
// is).  Blocks are persistent over the tiles of their channel group
// (blockIdx.y); (tile, chunk) stages stream through a ring of two cp.async
// buffers, the next landing while this one's FMAs run, across tiles; the
// group's weights stay resident where they fit (a.resident), else each
// stage carries its chunk's.
template <int S, int WC, bool DECONV>
__global__ void __launch_bounds__(kF32Threads, 2)
conv3x3_f32_kernel(F32Args a) {
  using Tl = rife_f32::Tile<S, WC, DECONV>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const wres = reinterpret_cast<float*>(smem);
  float* const ring = wres + (a.resident ? a.cin * Tl::kTaps * Tl::kCt : 0);
  const int in_floats = stage_in_floats(a.kc, Tl::kIn);
  const int stage_floats = in_floats + (a.resident ? 0 : a.kc * Tl::kTaps * Tl::kCt);

  constexpr int R = Tl::R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp / Tl::kWr;  // the warp's tile channels: wc * kCw ..
  const int row0 = rife_f32::warp_row0(warp, Tl::kWr, R);  // its first row of the tile
  const int g = blockIdx.y;
  const int my_tiles = rife_f32::block_tiles(a.n_tiles, blockIdx.x, gridDim.x);
  const int total = my_tiles * a.n_chunks;

  if (a.resident) stage_weights<S, WC, DECONV>(a, g, 0, a.cin, wres);
  stage_at<S, WC, DECONV>(a, 0, g, in_floats, ring);
  cp_async_commit();

  float acc[R][Tl::kCw];
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int c = 0; c < Tl::kCw; ++c) acc[p][c] = 0.0f;

#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    cp_async_wait_all();
    __syncthreads();  // stage it landed; every warp is done with stage it - 1
    if (it + 1 < total)
      stage_at<S, WC, DECONV>(a, it + 1, g, in_floats, ring + ((it + 1) & 1) * stage_floats);
    cp_async_commit();

    const int k = it % a.n_chunks;
    const int c0 = chunk_start(k, a.cin, a.n_chunks);
    const int kc = chunk_start(k + 1, a.cin, a.n_chunks) - c0;
    const float* xs = ring + (it & 1) * stage_floats;
    const float* ws =
        (a.resident ? wres + c0 * Tl::kTaps * Tl::kCt : xs + in_floats) + wc * Tl::kCw;
#pragma unroll 1
    for (int ci = 0; ci < kc; ++ci) {
      const float* xr = xs + ci * Tl::kIn + row0 * S * Tl::kIw + lane * S + Tl::kX;
      float win[Tl::kWin][3];
#pragma unroll
      for (int r = 0; r < Tl::kWin; ++r)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) win[r][kx] = xr[r * Tl::kIw + kx];
      const float* wt = ws + ci * Tl::kTaps * Tl::kCt;
      if (DECONV) {
        // phase by phase, its four taps (ry, rx) in (ky, kx) order; the
        // next step's four weights load while this step's FMAs run
        float4 wv[2];
        wv[0] = *reinterpret_cast<const float4*>(wt);
#pragma unroll
        for (int step = 0; step < 16; ++step) {
          const int ph = step / 4, k4 = step % 4;
          if (step < 15)
            wv[(step + 1) & 1] = *reinterpret_cast<const float4*>(
                wt + ((step + 1) % 4) * Tl::kCt + 4 * ((step + 1) / 4));
          const float4 w4 = wv[step & 1];
          const int ky = (ph >> 1) + (k4 >> 1), kx = (ph & 1) + (k4 & 1);
#pragma unroll
          for (int p = 0; p < R; ++p) {
            const float v = win[p + ky][kx];
            acc[p][4 * ph] = fmaf(v, w4.x, acc[p][4 * ph]);
            acc[p][4 * ph + 1] = fmaf(v, w4.y, acc[p][4 * ph + 1]);
            acc[p][4 * ph + 2] = fmaf(v, w4.z, acc[p][4 * ph + 2]);
            acc[p][4 * ph + 3] = fmaf(v, w4.w, acc[p][4 * ph + 3]);
          }
        }
      } else {
        // the next tap's weights load while this tap's FMAs run
        float wv[2][Tl::kCw];
#pragma unroll
        for (int q = 0; q < Tl::kCw / 4; ++q) {
          const float4 t4 = *reinterpret_cast<const float4*>(wt + 4 * q);
          wv[0][4 * q] = t4.x;
          wv[0][4 * q + 1] = t4.y;
          wv[0][4 * q + 2] = t4.z;
          wv[0][4 * q + 3] = t4.w;
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          if (tap < 8) {
#pragma unroll
            for (int q = 0; q < Tl::kCw / 4; ++q) {
              const float4 t4 =
                  *reinterpret_cast<const float4*>(wt + (tap + 1) * Tl::kCt + 4 * q);
              wv[(tap + 1) & 1][4 * q] = t4.x;
              wv[(tap + 1) & 1][4 * q + 1] = t4.y;
              wv[(tap + 1) & 1][4 * q + 2] = t4.z;
              wv[(tap + 1) & 1][4 * q + 3] = t4.w;
            }
          }
          const int ky = tap / 3, kx = tap % 3;
#pragma unroll
          for (int p = 0; p < R; ++p) {
            const float v = win[p * S + ky][kx];
#pragma unroll
            for (int c = 0; c < Tl::kCw; ++c) acc[p][c] = fmaf(v, wv[tap & 1][c], acc[p][c]);
          }
        }
      }
    }
    if (k != a.n_chunks - 1) continue;

    // the tile's epilogue: the f32 bias and the activation, one rounding
    // (each channel's bias and negative-side factor in registers: the
    // stores may alias them); the sums restart
    const rife_f32::TileAt at = tile_at<S, WC, DECONV>(a, blockIdx.x + (it / a.n_chunks) * gridDim.x);
    const int ox = at.ox0 + lane;
    const int o0 = g * Tl::kGroupOut + rife_f32::warp_ch0(warp, Tl::kWr, Tl::kOutCh);
    float eb[Tl::kCw], ek[Tl::kCw];
#pragma unroll
    for (int c = 0; c < Tl::kCw; ++c) {
      // channel c of this thread: deconv phase c / 4 of channel o0 + c % 4
      const int ch = DECONV ? o0 + c % 4 : o0 + c;
      const int at_ch = DECONV ? (c / 4) * a.cout + ch : ch;  // bias and slope index
      const bool ok = ch < a.cout;
      eb[c] = ok && a.bias != nullptr ? a.bias[at_ch] : 0.0f;
      ek[c] = !ok ? 0.0f : a.act == kPrelu ? a.slope[at_ch] : a.alpha;
    }
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const int oy = at.oy0 + row0 + p;
      const bool in = ox < a.wo && oy < a.ho;
#pragma unroll
      for (int c = 0; c < Tl::kCw; ++c)
        acc[p][c] = finish(acc[p][c], a.bias != nullptr, eb[c], a.act, ek[c]);
      if (DECONV) {
        // phases (py, 0) and (py, 1) of channel o: two neighbours of output
        // row 2 oy + py, one 8-byte store
#pragma unroll
        for (int py = 0; py < 2; ++py)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = o0 + j;
            if (in && o < a.cout)
              *reinterpret_cast<float2*>(
                  a.out +
                  ((static_cast<size_t>(at.b) * a.cout + o) * 2 * a.ho + 2 * oy + py) * 2 * a.wo +
                  2 * ox) = make_float2(acc[p][8 * py + j], acc[p][8 * py + 4 + j]);
          }
      } else {
#pragma unroll
        for (int c = 0; c < Tl::kCw; ++c)
          if (in && o0 + c < a.cout)
            a.out[((static_cast<size_t>(at.b) * a.cout + o0 + c) * a.ho + oy) * a.wo + ox] =
                acc[p][c];
      }
#pragma unroll
      for (int c = 0; c < Tl::kCw; ++c) acc[p][c] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTw = 16;     // output columns of a tile (the m16 rows of an MMA)
constexpr int kChunk = 16;  // input channels of a stage (the k16 of an MMA)
constexpr int kXOff = 3;    // staged column of input x = ox0*S - 1 (tile origin - 4)

template <int S>
struct TcTile {
  static constexpr int kR = S == 1 ? 2 : 1;            // output rows per warp
  static constexpr int kTh = kWarps * kR;              // output rows per tile
  static constexpr int kIh = (kTh - 1) * S + 3;        // staged input rows
  static constexpr int kIw = S == 1 ? 24 : 36;         // staged columns (x4)
  static constexpr int kNv = kIw / 4;                  // 4-column vectors a row
  static constexpr int kCs = S == 1 ? 24 : 20;         // elements a staged pixel
  static constexpr int kItems = kIh * kNv * (kChunk / 2);  // (row, vector, pair)
  static constexpr int kIpt = (kItems + kThreads - 1) / kThreads;
  static constexpr int kBuf = kIh * kIw * kCs;         // elements of one stage
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

struct TcArgs {
  Parts parts;
  const __nv_bfloat16* wtc;  // (9, cout, cp) packed weights
  const float* bias;
  const float* slope;
  __nv_bfloat16* out;
  int cin, cp, h, w, cout, ho, wo, act;
  float alpha;
  int tiles_x, tiles_y, n_tiles;
  int group_ch;  // output channels of a group (blockIdx.y)
  int vec_in;    // 8-byte input loads allowed (W % 4 == 0, parts 8-byte aligned)
};

// Load one 16-channel chunk of tile t into registers: item i of this thread
// is (row, 4-column vector, channel pair p = tid % 8); pre[i] holds the two
// channels' 4 columns.
template <int S>
__device__ __forceinline__ void load_chunk(const TcArgs& a, int t, int chunk,
                                           uint2 (&pre)[TcTile<S>::kIpt][2]) {
  using Tl = TcTile<S>;
  const int tx = t % a.tiles_x, r0 = t / a.tiles_x;
  const int ty = r0 % a.tiles_y, b = r0 / a.tiles_y;
  const int iy0 = ty * Tl::kTh * S - 1, xs0 = tx * kTw * S - 1 - kXOff;
  const int p = threadIdx.x & 7;
  const int c0 = chunk * kChunk + 2 * p;
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  const __nv_bfloat16* q[2] = {
      c0 < a.cin ? channel_plane<__nv_bfloat16>(a.parts, b, c0, plane) : nullptr,
      c0 + 1 < a.cin ? channel_plane<__nv_bfloat16>(a.parts, b, c0 + 1, plane) : nullptr};
#pragma unroll
  for (int i = 0; i < Tl::kIpt; ++i) {
    const int item = threadIdx.x + i * kThreads;
    const int rv = item >> 3;
    const int r = rv / Tl::kNv, v = rv % Tl::kNv;
    const int gy = iy0 + r, gx = xs0 + 4 * v;
    const bool row_in = item < Tl::kItems && gy >= 0 && gy < a.h;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      uint2 val = make_uint2(0u, 0u);
      if (row_in && q[k] != nullptr) {
        const __nv_bfloat16* src = q[k] + static_cast<size_t>(gy) * a.w;
        if (a.vec_in) {
          if (gx >= 0 && gx < a.w) val = __ldg(reinterpret_cast<const uint2*>(src + gx));
        } else {
          uint32_t e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            e[j] = gx + j >= 0 && gx + j < a.w ? bf16_bits(src + gx + j) : 0u;
          val = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
        }
      }
      pre[i][k] = val;
    }
  }
}

// Transpose the registers into a stage buffer, [row][col][channel].
template <int S>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* buf,
                                            const uint2 (&pre)[TcTile<S>::kIpt][2]) {
  using Tl = TcTile<S>;
  const int p = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < Tl::kIpt; ++i) {
    const int item = threadIdx.x + i * kThreads;
    if (item >= Tl::kItems) break;
    const int rv = item >> 3;
    const int r = rv / Tl::kNv, v = rv % Tl::kNv;
    uint32_t* dst = reinterpret_cast<uint32_t*>(buf + (r * Tl::kIw + 4 * v) * Tl::kCs + 2 * p);
    const uint2 c0 = pre[i][0], c1 = pre[i][1];
    dst[0] = __byte_perm(c0.x, c1.x, 0x5410);
    dst[Tl::kCs / 2] = __byte_perm(c0.x, c1.x, 0x7632);
    dst[Tl::kCs] = __byte_perm(c0.y, c1.y, 0x5410);
    dst[3 * Tl::kCs / 2] = __byte_perm(c0.y, c1.y, 0x7632);
  }
}

template <int S, int NT>
__global__ void __launch_bounds__(kThreads)
conv3x3_tc_kernel(TcArgs a) {
  using Tl = TcTile<S>;
  constexpr int kN = NT * 8;  // output channels a block holds
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpw = a.cp + 8;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [9][kN][cpw]
  __nv_bfloat16* xs = ws + 9 * kN * cpw;                       // [2][kIh][kIw][kCs]
  __nv_bfloat16* ob = xs + 2 * Tl::kBuf;                       // [kWarps][kN][kTw]
  float* eb = reinterpret_cast<float*>(ob + kWarps * kN * kTw);  // [kN] bias
  float* ek = eb + kN;  // [kN] the factor of a negative value (leaky, PReLU)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int g0 = blockIdx.y * a.group_ch;
  const int n_valid = min(a.group_ch, a.cout - g0);
  const int n_chunks = a.cp / kChunk;
  const int my_tiles = (a.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int total = my_tiles * n_chunks;

  // the group's bias and activation factors and weights, once; the weights
  // as 16-byte rows of the packed (9, cout, cp) array
  for (int n = threadIdx.x; n < kN; n += kThreads) {
    const bool ok = n < n_valid;
    eb[n] = ok && a.bias != nullptr ? a.bias[g0 + n] : 0.0f;
    ek[n] = !ok ? 0.0f : a.act == kPrelu ? a.slope[g0 + n] : a.alpha;
  }
  {
    const int vecs = a.cp / 8;
    for (int i = threadIdx.x; i < 9 * kN * vecs; i += kThreads) {
      const int v = i % vecs, n = (i / vecs) % kN, tap = i / (vecs * kN);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < n_valid)
        val = __ldg(reinterpret_cast<const uint4*>(
            a.wtc + (static_cast<size_t>(tap) * a.cout + g0 + n) * a.cp + 8 * v));
      *reinterpret_cast<uint4*>(ws + (tap * kN + n) * cpw + 8 * v) = val;
    }
  }

  uint2 pre[Tl::kIpt][2];
  load_chunk<S>(a, blockIdx.x, 0, pre);
  store_chunk<S>(xs, pre);
  __syncthreads();

  float acc[Tl::kR][NT][4];
#pragma unroll
  for (int rr = 0; rr < Tl::kR; ++rr)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rr][j][e] = 0.0f;

  __nv_bfloat16* obw = ob + warp * kN * kTw;
  for (int it = 0; it < total; ++it) {
    const int chunk = it % n_chunks;
    const int t = blockIdx.x + (it / n_chunks) * gridDim.x;
    const bool more = it + 1 < total;
    if (more)
      load_chunk<S>(a, blockIdx.x + ((it + 1) / n_chunks) * gridDim.x, (it + 1) % n_chunks,
                    pre);

    // the chunk's MMAs: 9 taps x kR m16 tiles x NT n8 tiles
    const __nv_bfloat16* xb = xs + (it & 1) * Tl::kBuf;
    // the B fragments of the next tap load while this tap's MMAs run (left
    // to the compiler, the loads and MMAs serialized at some NT)
    uint32_t bfs[2][NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* wp = ws + (j * 8 + g) * cpw + chunk * kChunk + 2 * tig;
      bfs[0][j][0] = lds32(wp);
      bfs[0][j][1] = lds32(wp + 8);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      if (tap < 8) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* wp =
              ws + ((tap + 1) * kN + j * 8 + g) * cpw + chunk * kChunk + 2 * tig;
          bfs[(tap + 1) & 1][j][0] = lds32(wp);
          bfs[(tap + 1) & 1][j][1] = lds32(wp + 8);
        }
      }
      const uint32_t(&bf)[NT][2] = bfs[tap & 1];
#pragma unroll
      for (int rr = 0; rr < Tl::kR; ++rr) {
        const int row = (warp * Tl::kR + rr) * S + ky;
        const __nv_bfloat16* ap = xb + (row * Tl::kIw + g * S + kx + kXOff) * Tl::kCs + 2 * tig;
        constexpr int kHalf = 8 * S * Tl::kCs;  // pixel g + 8
        const uint32_t af[4] = {lds32(ap), lds32(ap + kHalf), lds32(ap + 8),
                                lds32(ap + kHalf + 8)};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[rr][j], af, bf[j]);
      }
    }

    if (chunk == n_chunks - 1) {
      // epilogue of tile t: bias, activation, one rounding, staged per warp
      const int tx = t % a.tiles_x, r0 = t / a.tiles_x;
      const int ty = r0 % a.tiles_y, b = r0 / a.tiles_y;
      const int ox0 = tx * kTw;
      const bool has_bias = a.bias != nullptr;
#pragma unroll
      for (int rr = 0; rr < Tl::kR; ++rr) {
        const int oy = ty * Tl::kTh + warp * Tl::kR + rr;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = j * 8 + 2 * tig + (e & 1);
            const int x = g + 8 * (e >> 1);
            float v = acc[rr][j][e];
            if (has_bias) v = __fadd_rn(v, eb[n]);
            if (a.act == kRelu) {
              v = fmaxf(v, 0.0f);
            } else if (a.act != kNone) {
              v = v >= 0.0f ? v : __fmul_rn(v, ek[n]);
            }
            obw[n * kTw + x] = __float2bfloat16_rn(v);
            acc[rr][j][e] = 0.0f;
          }
        }
        __syncwarp();
        if (oy < a.ho) {
          // channel n, 8 columns a lane: out[b][g0 + n][oy][ox0 + 8 h ...]
          const bool vec = (a.wo & 7) == 0;
          for (int idx = lane; idx < n_valid * 2; idx += 32) {
            const int n = idx >> 1, x0 = ox0 + 8 * (idx & 1);
            const __nv_bfloat16* src = obw + n * kTw + 8 * (idx & 1);
            __nv_bfloat16* dst =
                a.out + ((static_cast<size_t>(b) * a.cout + g0 + n) * a.ho + oy) * a.wo + x0;
            if (vec && x0 + 8 <= a.wo) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
              for (int k = 0; k < 8 && x0 + k < a.wo; ++k) dst[k] = src[k];
            }
          }
        }
        __syncwarp();
      }
    }

    if (more) store_chunk<S>(xs + ((it + 1) & 1) * Tl::kBuf, pre);
    __syncthreads();
  }
}

// What the launch needs to know of the calling thread's current device (the
// wrapper's device guard sets it: ops/launch.py), read once per device.  The
// table and the per-kernel attribute flags below are shared by every host
// thread that launches, so they are read and written under one lock.
constexpr int kMaxDevices = 64;

struct DeviceInfo {
  int id, sms, smem_optin;
};

std::mutex g_devices_lock;
DeviceInfo g_devices[kMaxDevices] = {};  // sms == 0: not read yet

cudaError_t current_device_info(DeviceInfo* info) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(g_devices_lock);
  DeviceInfo& d = g_devices[dev];
  if (d.sms == 0) {
    int sms = 0, smem = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc != cudaSuccess) return rc;
    d = DeviceInfo{dev, sms, smem};
  }
  *info = d;
  return cudaSuccess;
}

// raises conv3x3_tc_kernel<S, NT>'s dynamic shared memory limit to the
// device's opt-in, once per device
template <int S, int NT>
cudaError_t allow_smem(const DeviceInfo& dev) {
  static bool done[kMaxDevices] = {};
  std::lock_guard<std::mutex> hold(g_devices_lock);
  if (done[dev.id]) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(
      conv3x3_tc_kernel<S, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, dev.smem_optin);
  if (rc == cudaSuccess) done[dev.id] = true;
  return rc;
}

template <int S, int NT>
cudaError_t launch_tc(TcArgs a, int batch, int n_groups, const DeviceInfo& dev,
                      cudaStream_t s) {
  using Tl = TcTile<S>;
  const size_t smem = (static_cast<size_t>(9) * NT * 8 * (a.cp + 8) + 2 * Tl::kBuf +
                       static_cast<size_t>(kWarps) * NT * 8 * kTw) *
                          sizeof(__nv_bfloat16) +
                      2 * NT * 8 * sizeof(float);
  if (smem > static_cast<size_t>(dev.smem_optin)) return cudaErrorInvalidConfiguration;
  cudaError_t rc = allow_smem<S, NT>(dev);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv3x3_tc_kernel<S, NT>, kThreads, smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  a.tiles_x = (a.wo + kTw - 1) / kTw;
  a.tiles_y = (a.ho + Tl::kTh - 1) / Tl::kTh;
  const long long tiles = static_cast<long long>(batch) * a.tiles_x * a.tiles_y;
  if (tiles > (1LL << 30)) return cudaErrorInvalidConfiguration;
  a.n_tiles = static_cast<int>(tiles);
  const int blocks = max(1, per_sm * dev.sms / n_groups);
  dim3 grid(static_cast<unsigned>(min(a.n_tiles, blocks)), static_cast<unsigned>(n_groups));
  conv3x3_tc_kernel<S, NT><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch_tc(const TcArgs& a, int batch, int n_groups, const DeviceInfo& dev,
                        cudaStream_t s) {
  switch ((a.group_ch + 15) / 16) {
    case 1: return launch_tc<S, 2>(a, batch, n_groups, dev, s);
    case 2: return launch_tc<S, 4>(a, batch, n_groups, dev, s);
    case 3: return launch_tc<S, 6>(a, batch, n_groups, dev, s);
    case 4: return launch_tc<S, 8>(a, batch, n_groups, dev, s);
    default: return cudaErrorInvalidConfiguration;
  }
}

// raises conv3x3_f32_kernel<...>'s dynamic shared memory limit to the
// device's opt-in, once per device
template <int S, int WC, bool DECONV>
cudaError_t allow_smem_f32(const DeviceInfo& dev) {
  static bool done[kMaxDevices] = {};
  std::lock_guard<std::mutex> hold(g_devices_lock);
  if (done[dev.id]) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(conv3x3_f32_kernel<S, WC, DECONV>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        dev.smem_optin);
  // all of the SM's unified memory as shared memory, so two blocks fit
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(conv3x3_f32_kernel<S, WC, DECONV>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc == cudaSuccess) done[dev.id] = true;
  return rc;
}

// one launch of plan p (rife_f32::plan): as many persistent blocks a
// channel group as fit on the SMs, the group's tiles shared among them
template <int S, int WC, bool DECONV>
cudaError_t launch_f32(F32Args a, const rife_f32::Plan& p, const DeviceInfo& dev,
                       cudaStream_t s) {
  if (p.smem > dev.smem_optin) return cudaErrorInvalidConfiguration;
  a.kc = p.kc;
  a.n_chunks = p.n_chunks;
  a.resident = p.resident;
  a.tiles_x = p.tiles_x;
  a.tiles_y = p.tiles_y;
  a.n_tiles = p.n_tiles;
  cudaError_t rc = allow_smem_f32<S, WC, DECONV>(dev);
  if (rc != cudaSuccess) return rc;
  int per_sm = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_f32_kernel<S, WC, DECONV>,
                                                     kF32Threads, p.smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const int blocks = max(1, per_sm * dev.sms / p.groups);
  dim3 grid(static_cast<unsigned>(min(p.n_tiles, blocks)), static_cast<unsigned>(p.groups));
  conv3x3_f32_kernel<S, WC, DECONV><<<grid, kF32Threads, p.smem, s>>>(a);
  return cudaGetLastError();
}

template <int S, bool DECONV>
cudaError_t dispatch_f32(const F32Args& a, const rife_f32::Plan& p, const DeviceInfo& dev,
                         cudaStream_t s) {
  if (p.wc == 1) return launch_f32<S, 1, DECONV>(a, p, dev, s);
  if (p.wc == 2) return launch_f32<S, 2, DECONV>(a, p, dev, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface, f32.  Parts x0..x3: contiguous NCHW (B,c_i,H,W) float32,
// unused parts null with c_i = 0; weight float32, cp = cin rounded up to 16,
// zero past cin: conv (9, cout, cp) (pack_weight_tc), deconv (16, cout, cp)
// (pack_weight_t4, cout = O); bias and slope float32 (cout,), deconv (4
// cout,) tiled by phase, or null; out (B, cout, Ho, Wo), Ho = (H-1)/stride
// + 1, deconv (B, cout, 2H, 2W) at stride 1.  The launch's tiles, channel
// groups, stages and resident weights: rife_f32::plan (conv_f32_plan.h).
// Returns cudaGetLastError() right after the launch, or the reason the
// launch was refused.
extern "C" int rife_conv3x3(const void* x0, const void* x1, const void* x2, const void* x3,
                            int c0, int c1, int c2, int c3, const void* weight, int cp,
                            const void* bias, const void* slope, void* out, int batch, int h,
                            int w, int cout, int stride, int act, float alpha, int deconv,
                            void* stream) {
  const Parts parts = {{x0, x1, x2, x3}, {c0, c1, c2, c3}};
  const int cin = c0 + c1 + c2 + c3;
  rife_f32::Plan p;
  if (cp < cin || act < kNone || act > kPrelu || (act == kPrelu && slope == nullptr) ||
      !rife_f32::plan(batch, cin, cout, h, w, stride, deconv != 0, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo dev;
  const cudaError_t dev_rc = current_device_info(&dev);
  if (dev_rc != cudaSuccess) return static_cast<int>(dev_rc);
  F32Args a{};
  a.parts = parts;
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.slope = static_cast<const float*>(slope);
  a.out = static_cast<float*>(out);
  a.cin = cin;
  a.cp = cp;
  a.h = h;
  a.w = w;
  a.cout = cout;
  a.ho = (h - 1) / stride + 1;
  a.wo = (w - 1) / stride + 1;
  a.act = act;
  a.alpha = alpha;
  bool aligned = (w & 3) == 0;
  for (int k = 0; k < kMaxParts; ++k)
    aligned = aligned && (reinterpret_cast<uintptr_t>(parts.ptr[k]) & 15) == 0;
  a.vec = aligned ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      deconv ? dispatch_f32<1, true>(a, p, dev, s)
             : (stride == 1 ? dispatch_f32<1, false>(a, p, dev, s)
                            : dispatch_f32<2, false>(a, p, dev, s));
  return static_cast<int>(rc);
}

// C interface, bf16 on the tensor cores.  Parts as above in bf16; weight_tc
// the packed (9, cout, cp) bf16 weights, cp = cin rounded up to 16, zero past
// cin; bias and slope float32 (cout,) or null.  out (B, cout, Ho, Wo) as
// above.  Returns cudaGetLastError() right after the launch, or the reason the
// launch was refused.
extern "C" int rife_conv3x3_tc(const void* x0, const void* x1, const void* x2, const void* x3,
                               int c0, int c1, int c2, int c3, const void* weight_tc, int cp,
                               const void* bias, const void* slope, void* out, int batch, int h,
                               int w, int cout, int stride, int act, float alpha,
                               void* stream) {
  const Parts parts = {{x0, x1, x2, x3}, {c0, c1, c2, c3}};
  const int cin = c0 + c1 + c2 + c3;
  if (cin <= 0 || cout <= 0 || cp < cin || cp % kChunk || (stride != 1 && stride != 2) ||
      act < kNone || act > kPrelu || (act == kPrelu && slope == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo dev;
  const cudaError_t dev_rc = current_device_info(&dev);
  if (dev_rc != cudaSuccess) return static_cast<int>(dev_rc);
  TcArgs a{};
  a.parts = parts;
  a.wtc = static_cast<const __nv_bfloat16*>(weight_tc);
  a.bias = static_cast<const float*>(bias);
  a.slope = static_cast<const float*>(slope);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.cin = cin;
  a.cp = cp;
  a.h = h;
  a.w = w;
  a.cout = cout;
  a.ho = (h - 1) / stride + 1;
  a.wo = (w - 1) / stride + 1;
  a.act = act;
  a.alpha = alpha;
  bool aligned = (w & 3) == 0;
  for (int k = 0; k < kMaxParts; ++k)
    aligned = aligned && (reinterpret_cast<uintptr_t>(parts.ptr[k]) & 7) == 0;
  a.vec_in = aligned ? 1 : 0;
  // groups of at most 64 output channels
  const int n_groups = (cout + 63) / 64;
  a.group_ch = (cout + n_groups - 1) / n_groups;
  if (a.group_ch > 64 || n_groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = stride == 1 ? dispatch_tc<1>(a, batch, n_groups, dev, s)
                                     : dispatch_tc<2>(a, batch, n_groups, dev, s);
  return static_cast<int>(rc);
}
