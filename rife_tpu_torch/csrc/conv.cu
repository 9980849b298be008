// Hand-written Hopper (sm_90a) kernels for the planar conv sites of the
// v2.3 and v1 paths: a 3x3 pad-1 conv, stride 1 or 2, over the channel concat of
// 1-4 input parts (the concat is never built), f32 accumulation, the f32
// bias and the activation (none, ReLU, leaky, per-channel PReLU) in f32 and
// one rounding to the storage dtype.
// In f32 a deconv site (4x4 stride-2 transposed conv) runs as the stride-1
// conv over its four output phases; in bf16 it takes csrc/deconv.cu.  Plain C
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
// f32 (not the main path) keeps the CUDA-core kernel conv3x3_kernel: TF32
// tensor cores would break the f32 bars.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxParts = 4;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kPrelu = 3 };

struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];
};

__device__ __forceinline__ float activate(float v, int act, float alpha, float slope) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.0f);
    case kLeaky: return v >= 0.0f ? v : __fmul_rn(v, alpha);
    case kPrelu: return v >= 0.0f ? v : __fmul_rn(v, slope);
    default: return v;
  }
}

__device__ __forceinline__ float epilogue(float v, int co, const float* bias, int act,
                                          float alpha, const float* slope) {
  if (bias != nullptr) v = __fadd_rn(v, bias[co]);
  return activate(v, act, alpha, slope != nullptr ? slope[co] : 0.0f);
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

constexpr int kTx = 32;  // threads along x, one output column each
constexpr int kTy = 8;   // threads along y
constexpr int kCo = 16;  // output channels per block (registers per thread)

template <int S>
struct Tile {
  static constexpr int kPy = S == 1 ? 4 : 2;       // output rows per thread
  static constexpr int kOh = kTy * kPy;             // output rows per block
  static constexpr int kOw = kTx;                   // output columns per block
  static constexpr int kIh = (kOh - 1) * S + 3;     // input rows with halo
  static constexpr int kIw = (kOw - 1) * S + 3;     // input columns with halo
  static constexpr int kCi = S == 1 ? 8 : 4;        // input channels per stage
  static constexpr int kWin = (kPy - 1) * S + 3;    // rows of a thread's window
};

// A block computes a 32-wide output tile of 32 rows (stride 1) or 16 rows
// (stride 2) for 16 output channels; 256 threads, each one output column, 4
// (or 2) output rows and the 16 channels.  Input channels stream through
// shared memory in stages of 8 (or 4), the stage's weights laid out [ci][tap]
// [co] so a thread reads its 16 weights of a tap as four float4 broadcasts.
template <int S>
__global__ void __launch_bounds__(kTx * kTy)
conv3x3_kernel(Parts parts, const float* __restrict__ weight, const float* __restrict__ bias,
               const float* __restrict__ slope, float* __restrict__ out, int cin, int h, int w,
               int cout, int ho, int wo, int act, float alpha, int n_groups) {
  using Tl = Tile<S>;
  __shared__ float xs[Tl::kCi][Tl::kIh][Tl::kIw];
  __shared__ __align__(16) float ws[Tl::kCi][9][kCo];
  __shared__ const float* chan[Tl::kCi];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int b = blockIdx.z / n_groups;
  const int co0 = (blockIdx.z % n_groups) * kCo;
  const int ox0 = blockIdx.x * Tl::kOw, oy0 = blockIdx.y * Tl::kOh;
  const int ix0 = ox0 * S - 1, iy0 = oy0 * S - 1;
  const size_t plane = static_cast<size_t>(h) * w;

  float acc[Tl::kPy][kCo];
#pragma unroll
  for (int p = 0; p < Tl::kPy; ++p)
#pragma unroll
    for (int c = 0; c < kCo; ++c) acc[p][c] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += Tl::kCi) {
    if (tid < Tl::kCi)
      chan[tid] = ci0 + tid < cin ? channel_plane<float>(parts, b, ci0 + tid, plane) : nullptr;
    __syncthreads();

    // input tile with halo, zero outside the frame and past cin
    constexpr int kTileN = Tl::kCi * Tl::kIh * Tl::kIw;
    for (int i = tid; i < kTileN; i += kTx * kTy) {
      const int ci = i / (Tl::kIh * Tl::kIw);
      const int r = (i / Tl::kIw) % Tl::kIh;
      const int c = i % Tl::kIw;
      const int gy = iy0 + r, gx = ix0 + c;
      const float* src = chan[ci];
      float v = 0.0f;
      if (src != nullptr && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = __ldg(src + static_cast<size_t>(gy) * w + gx);
      xs[ci][r][c] = v;
    }
    // the stage's weights as [ci][tap][co], zero past cin / cout
    constexpr int kWN = Tl::kCi * 9 * kCo;
    for (int i = tid; i < kWN; i += kTx * kTy) {
      const int co = i % kCo;
      const int tap = (i / kCo) % 9;
      const int ci = i / (kCo * 9);
      const int gco = co0 + co, gci = ci0 + ci;
      float v = 0.0f;
      if (gco < cout && gci < cin)
        v = __ldg(weight + (static_cast<size_t>(gco) * cin + gci) * 9 + tap);
      ws[ci][tap][co] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < Tl::kCi; ++ci) {
      float win[Tl::kWin][3];
#pragma unroll
      for (int r = 0; r < Tl::kWin; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) win[r][k] = xs[ci][ty * Tl::kPy * S + r][tx * S + k];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        float wr[kCo];
        const float4* wv = reinterpret_cast<const float4*>(&ws[ci][tap][0]);
#pragma unroll
        for (int q = 0; q < kCo / 4; ++q) {
          const float4 t = wv[q];
          wr[4 * q] = t.x;
          wr[4 * q + 1] = t.y;
          wr[4 * q + 2] = t.z;
          wr[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int p = 0; p < Tl::kPy; ++p) {
          const float v = win[p * S + ky][kx];
#pragma unroll
          for (int c = 0; c < kCo; ++c) acc[p][c] = fmaf(v, wr[c], acc[p][c]);
        }
      }
    }
    __syncthreads();
  }

  const int ox = ox0 + tx;
  if (ox >= wo) return;
#pragma unroll
  for (int p = 0; p < Tl::kPy; ++p) {
    const int oy = oy0 + ty * Tl::kPy + p;
    if (oy >= ho) continue;
#pragma unroll
    for (int c = 0; c < kCo; ++c) {
      const int co = co0 + c;
      if (co >= cout) continue;
      out[((static_cast<size_t>(b) * cout + co) * ho + oy) * wo + ox] =
          epilogue(acc[p][c], co, bias, act, alpha, slope);
    }
  }
}

template <int S>
cudaError_t launch_f32(const Parts& parts, const float* weight, const float* bias,
                       const float* slope, float* out, int batch, int cin, int h, int w,
                       int cout, int act, float alpha, cudaStream_t s) {
  using Tl = Tile<S>;
  const int ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const int groups = (cout + kCo - 1) / kCo;
  const long long z = static_cast<long long>(batch) * groups;
  if (z > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((wo + Tl::kOw - 1) / Tl::kOw, (ho + Tl::kOh - 1) / Tl::kOh,
            static_cast<unsigned>(z));
  dim3 block(kTx, kTy);
  conv3x3_kernel<S><<<grid, block, 0, s>>>(parts, weight, bias, slope, out, cin, h, w, cout,
                                           ho, wo, act, alpha, groups);
  return cudaGetLastError();
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

}  // namespace

// C interface, f32.  Parts x0..x3: contiguous NCHW (B,c_i,H,W) float32,
// unused parts null with c_i = 0; weight (cout, sum c_i, 3, 3) float32; bias
// and slope float32 (cout,) or null; out (B, cout, Ho, Wo), Ho = (H-1)/stride
// + 1.  Returns cudaGetLastError() right after the launch.
extern "C" int rife_conv3x3(const void* x0, const void* x1, const void* x2, const void* x3,
                            int c0, int c1, int c2, int c3, const void* weight,
                            const void* bias, const void* slope, void* out, int batch, int h,
                            int w, int cout, int stride, int act, float alpha, void* stream) {
  const Parts parts = {{x0, x1, x2, x3}, {c0, c1, c2, c3}};
  const int cin = c0 + c1 + c2 + c3;
  if (cin <= 0 || cout <= 0 || (stride != 1 && stride != 2) || act < kNone ||
      act > kPrelu || (act == kPrelu && slope == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* wt = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  const float* sl = static_cast<const float*>(slope);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      stride == 1 ? launch_f32<1>(parts, wt, b, sl, o, batch, cin, h, w, cout, act, alpha, s)
                  : launch_f32<2>(parts, wt, b, sl, o, batch, cin, h, w, cout, act, alpha, s);
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
