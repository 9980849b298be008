// Hand-written Hopper (sm_90a) kernel for the 4x4 stride-2 pad-1 transposed
// convolutions of every bf16 path on the card (v4.6 rife.DeconvPS, v2.3 and
// v1 Deconvolution, planar-gated or not), optionally followed by a DCR
// PixelShuffle(2).  Plain C interface, loaded with ctypes by
// rife_tpu_torch/native/build.py; the PyTorch wrappers, the plain twins and
// the weight packing (pack_weight_t4) are in rife_tpu_torch/ops/conv.py.
//
// Replaces (rife_tpu/ops/conv_planar.py):
//   deconv_ps_planar (:784, B4's deconv form) and deconv_planar (:732): both
//   run the deconv as K11 (_conv_planar_s1_direct, :309) over a 3x3 phase
//   conv whose output channels are the four output phases; the TPU's
//   channel permutation only buys a free BHCW reshape.
//
// The function, per output phase (py, px) of input-grid pixel (m, n):
//   out[o][2m+py][2n+px] = sum_ci sum_{ry,rx} x[ci][m+py+ry-1][n+px+rx-1]
//                          * w[ci][o][3-py-2ry][3-px-2rx]
// so each phase reads 2x2 input pixels: 4 taps x Cin, where the phase conv
// form did 9 x Cin (2.25x the multiply-adds, zeros included).  The four
// phases together use each of the 16 raw taps once.
//
// What bounds it on the H100: at the v4.6 block tail (64 -> 24 at 272x480,
// B=8) it moves 0.33 GB (bf16 in and out once) and does 25.7 GMAC: 0.100 ms
// of bytes at 3.35 TB/s against 0.052 ms of bf16 tensor-core work at 989
// TFLOP/s (the phase conv's zeros made that 0.117 ms), so bytes bound it,
// provided mma.sync runs at over half its peak.  Measured (PERF.md section
// 6) it runs at about a fifth of that bound: the loads, the MMAs with their
// fragment loads and the epilogue each take a fifth to a third of its time
// and add up, so instruction throughput at two blocks an SM, not device-memory
// latency, sets its pace.
//
// What the design does about it:
// - GEMM per phase: M = 16 input columns (one m16 tile), N = a group of up to
//   24 output channels (NT n8 tiles), K = 16 input channels x 4 taps a chunk.
//   A block computes all four phases of a tile of 4 input rows x 16*MT
//   columns (MT = 2) from one staged input window (6 rows x 16*MT + 8
//   columns); warp w takes input row w/2 and phase row py = w%2, both px.
//   The 6 shifted A fragments of a tap row (3 shifts x MT) are loaded once
//   and shared by the two phases that read them, and each B fragment by
//   the MT m16 tiles.  Groups of at most 24 channels with two m16 tiles a
//   warp keep the kernel within 128 registers, two blocks an SM (groups of
//   32 took 160 and one block, and measured up to 12% slower at the wide
//   sites; groups of 64 with one m16 tile a warp move more bytes through
//   shared memory per MMA).  Fragments are read with ldmatrix.
// - Weights stream through shared memory a chunk at a time, double-buffered
//   with cp.async (16 taps x N x 16 channels, 16-byte halves XOR-swizzled so
//   the B fragment loads are free of bank conflicts), so any Cin fits (v1's
//   up0: 512 -> 128, v2.3's fusionnet: 1024 -> 256) and any number of
//   groups.
// - The input chunk is staged channels innermost as conv3x3_tc_kernel stages
//   it (registers prefetch the next chunk while the current one's MMAs run,
//   then a register transpose into the other buffer; a shift of the 2x2 taps
//   is a shift of the pixel address and every fragment load is free of bank
//   conflicts): one __syncthreads a chunk.  (A ring of three raw chunks in
//   flight through cp.async, transposed in shared memory, measured slower at
//   every site: PERF.md section 6.)
// - The epilogue is a template: PixelShuffle 1 or 2 and the two bias orders
//   (kXla false: f32 bias and activation, one rounding, as the planar
//   kernels; kXla true: the sum rounded to bf16, then the bf16 bias and the
//   activation in bf16, as XLA's conv and cuDNN's do).  Each warp stages its
//   output rows, phases and shuffle already interleaved, two neighbours a
//   32-bit store, and writes whole output rows as 16-byte vectors.
// - Sum order: per phase, chunk by chunk, the taps in (ry, rx) order: the
//   order of the nonzero taps of the phase conv, so the results equal it
//   bit for bit (its other MMAs added exact zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kPrelu = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;   // input channels of a stage (the k16 of an MMA)
constexpr int kRows = 4;     // input rows of a tile
constexpr int kMT = 2;       // m16 tiles (16 input columns each) a warp
constexpr int kTw = 16 * kMT;  // input columns of a tile
constexpr int kIh = kRows + 2;  // staged rows: the tile's and one each side
constexpr int kIw = kTw + 8;    // staged columns: input x0 - 4 .. x0 + kTw + 3
constexpr int kCs = 24;         // elements a staged pixel: 16 channels + 8 skew
constexpr int kXOff = 4;        // staged column of input column x0 (the origin)
constexpr int kNv = kIw / 4;    // 4-column vectors a staged row
constexpr int kItems = kIh * kNv * (kChunk / 2);  // (row, vector, channel pair)
constexpr int kIpt = (kItems + kThreads - 1) / kThreads;
constexpr int kBuf = kIh * kIw * kCs;  // elements of a staged chunk

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

__device__ __forceinline__ float qbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four 8x8 b16 matrices from shared memory, row addresses from lanes 8m..8m+7
// for matrix m; r[m] holds this lane's pair of matrix m (mma fragment order)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

struct DcArgs {
  const __nv_bfloat16* x;    // (B, cin, h, w)
  const __nv_bfloat16* wt4;  // (16, cout, cp) packed: (phase, tap, o, ci)
  const float* bias;         // (>= cout,) or null
  const float* slope;        // (>= cout,) PReLU, or null
  __nv_bfloat16* out;        // (B, cout / ps^2, 2 ps h, 2 ps w)
  int cin, cp, h, w, cout, act;
  float alpha;
  int tiles_x, tiles_y, n_tiles;
  int group_ch;  // output channels of a group (blockIdx.y)
  int vec_in;    // 8-byte input loads allowed (w % 4 == 0, x 8-byte aligned)
};

// Where tile t lies: batch item, tile row and tile column (worked out once
// a tile, not once a chunk).
struct TileAt {
  int b, ty, tx;
};

__device__ __forceinline__ TileAt tile_at(const DcArgs& a, int t) {
  const int r0 = t / a.tiles_x;
  return TileAt{r0 / a.tiles_y, r0 % a.tiles_y, t % a.tiles_x};
}

// Load one 16-channel chunk of a tile into registers: item i of this thread
// is (row, 4-column vector, channel pair p = tid % 8).
__device__ __forceinline__ void load_chunk(const DcArgs& a, const TileAt& at, int chunk,
                                           uint2 (&pre)[kIpt][2]) {
  const int b = at.b;
  const int iy0 = at.ty * kRows - 1, xs0 = at.tx * kTw - kXOff;
  const int p = threadIdx.x & 7;
  const int c0 = chunk * kChunk + 2 * p;
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  const __nv_bfloat16* q[2] = {
      c0 < a.cin ? a.x + (static_cast<size_t>(b) * a.cin + c0) * plane : nullptr,
      c0 + 1 < a.cin ? a.x + (static_cast<size_t>(b) * a.cin + c0 + 1) * plane : nullptr};
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int item = threadIdx.x + i * kThreads;
    const int rv = item >> 3;
    const int r = rv / kNv, v = rv % kNv;
    const int gy = iy0 + r, gx = xs0 + 4 * v;
    const bool row_in = item < kItems && gy >= 0 && gy < a.h;
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
__device__ __forceinline__ void store_chunk(__nv_bfloat16* buf, const uint2 (&pre)[kIpt][2]) {
  const int p = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int item = threadIdx.x + i * kThreads;
    if (item >= kItems) break;
    const int rv = item >> 3;
    const int r = rv / kNv, v = rv % kNv;
    uint32_t* dst = reinterpret_cast<uint32_t*>(buf + (r * kIw + 4 * v) * kCs + 2 * p);
    const uint2 c0 = pre[i][0], c1 = pre[i][1];
    dst[0] = __byte_perm(c0.x, c1.x, 0x5410);
    dst[kCs / 2] = __byte_perm(c0.x, c1.x, 0x7632);
    dst[kCs] = __byte_perm(c0.y, c1.y, 0x5410);
    dst[3 * kCs / 2] = __byte_perm(c0.y, c1.y, 0x7632);
  }
}

// The weights of one chunk for the group: 16 (phase, tap) x kN channels x
// 16 input channels, two 16-byte halves a row, half h of row n stored at
// half h ^ ((n >> 2) & 1); rows past the group's channels read as zeros.
template <int NT>
__device__ __forceinline__ void load_weights(const DcArgs& a, int chunk, int g0, int n_valid,
                                             __nv_bfloat16* ws) {
  constexpr int kN = NT * 8;
  for (int i = threadIdx.x; i < 16 * kN * 2; i += kThreads) {
    const int h = i & 1, n = (i >> 1) % kN, tap = (i >> 1) / kN;
    const bool ok = n < n_valid;
    const __nv_bfloat16* src =
        a.wt4 + (static_cast<size_t>(tap) * a.cout + (ok ? g0 + n : 0)) * a.cp + chunk * kChunk +
        8 * h;
    cp_async16(ws + (tap * kN + n) * 16 + 8 * (h ^ ((n >> 2) & 1)), src, ok);
  }
}

// The launch bound holds the kernel to 128 registers, two blocks an SM.
template <int NT, int PS, bool kXla>
__global__ void __launch_bounds__(kThreads, 2) deconv4x4_kernel(DcArgs a) {
  constexpr int MT = kMT;
  constexpr int kN = NT * 8;
  constexpr int kWChunk = 16 * kN * 16;   // elements of one chunk's weights
  constexpr int kSeg = 32 * MT * PS;      // output columns a staged row holds
  constexpr int kSegPad = kSeg + 8;
  constexpr int kSegs = PS == 1 ? kN : kN / 2;  // staged output rows a warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][16][kN][16]
  __nv_bfloat16* xs = ws + 2 * kWChunk;                         // [2][kIh][kIw][kCs]
  __nv_bfloat16* ob = xs + 2 * kBuf;  // [kWarps][kSegs][kSegPad]
  float* eb = reinterpret_cast<float*>(ob + kWarps * kSegs * kSegPad);  // [kN] bias
  float* ek = eb + kN;  // [kN] the factor of a negative value (leaky, PReLU)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row = warp >> 1, py = warp & 1;
  const int g0 = blockIdx.y * a.group_ch;
  const int n_valid = min(a.group_ch, a.cout - g0);
  const int n_chunks = a.cp / kChunk;
  const int my_tiles = (a.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int total = my_tiles * n_chunks;
  TileAt cur = tile_at(a, blockIdx.x), next = cur;
  int chunk = 0, t = blockIdx.x;

  for (int n = threadIdx.x; n < kN; n += kThreads) {
    const bool ok = n < n_valid;
    eb[n] = ok && a.bias != nullptr ? a.bias[g0 + n] : 0.0f;
    ek[n] = !ok ? 0.0f : a.act == kPrelu ? a.slope[g0 + n] : a.alpha;
  }
  uint2 pre[kIpt][2];
  load_weights<NT>(a, 0, g0, n_valid, ws);
  cp_async_commit();
  load_chunk(a, cur, 0, pre);
  store_chunk(xs, pre);
  cp_async_wait_all();
  __syncthreads();

  float acc[MT][2][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int px = 0; px < 2; ++px)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][px][j][e] = 0.0f;

  __nv_bfloat16* obw = ob + warp * kSegs * kSegPad;
  for (int it = 0; it < total; ++it) {
    int next_chunk = chunk + 1, next_t = t;
    if (next_chunk == n_chunks) {
      next_chunk = 0;
      next_t += gridDim.x;
      next = tile_at(a, next_t);
    }
    const bool more = it + 1 < total;
    if (more) {
      load_weights<NT>(a, next_chunk, g0, n_valid, ws + ((it + 1) & 1) * kWChunk);
      cp_async_commit();
      load_chunk(a, next, next_chunk, pre);
    }

    // the chunk's MMAs: per ry the three column shifts' A fragments, shared
    // by phase (py, 0) (shifts -1, 0) and (py, 1) (shifts 0, +1)
    const __nv_bfloat16* xb = xs + (it & 1) * kBuf;
    const __nv_bfloat16* wb = ws + (it & 1) * kWChunk;
#pragma unroll
    for (int ry = 0; ry < 2; ++ry) {
      const int srow = row + py + ry;  // staged row of input row m + py + ry - 1
      // A: lane l addresses row l % 8 of matrix l / 8: pixel l % 8 (+8 for
      // matrices 1, 3), channels 0-7 (matrices 0, 1) or 8-15 (2, 3)
      uint32_t af[MT][3][4];
      const int a_pix = (lane & 7) + 8 * ((lane >> 3) & 1), a_ch = 8 * (lane >> 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int s = 0; s < 3; ++s)
          ldsm_x4(af[mt][s],
                  xb + (srow * kIw + 16 * mt + a_pix + s + kXOff - 1) * kCs + a_ch);
#pragma unroll
      for (int px = 0; px < 2; ++px)
#pragma unroll
        for (int rx = 0; rx < 2; ++rx) {
          const int tap = (py * 2 + px) * 4 + ry * 2 + rx;
          // B: lane l addresses output channel n = 8 (j + l / 16) + l % 8,
          // half (l / 8) % 2 (stored at half h ^ ((n >> 2) & 1)): matrices
          // b0(j), b1(j), b0(j+1), b1(j+1)
          uint32_t bf[NT][2];
#pragma unroll
          for (int j = 0; j + 1 < NT; j += 2) {
            const int n = 8 * (j + (lane >> 4)) + (lane & 7);
            const int h = (lane >> 3) & 1;
            uint32_t r[4];
            ldsm_x4(r, wb + (tap * kN + n) * 16 + 8 * (h ^ ((n >> 2) & 1)));
            bf[j][0] = r[0];
            bf[j][1] = r[1];
            bf[j + 1][0] = r[2];
            bf[j + 1][1] = r[3];
          }
          if constexpr (NT % 2) {
            const int n = 8 * (NT - 1) + (lane & 7);
            const int h = (lane >> 3) & 1;
            ldsm_x2(bf[NT - 1], wb + (tap * kN + n) * 16 + 8 * (h ^ ((n >> 2) & 1)));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][px][j], af[mt][px + rx], bf[j]);
        }
    }
    if (chunk == n_chunks - 1) {
      // epilogue of tile t: bias, activation, rounding, staged interleaved
      const TileAt& at = cur;
      const int b = at.b, tx = at.tx;
      const int m = at.ty * kRows + row;
      const bool has_bias = a.bias != nullptr;
      auto finish = [&](float v, int n) {
        if constexpr (kXla) {
          v = qbf(v);
          if (has_bias) v = qbf(__fadd_rn(v, eb[n]));
          if (a.act == kRelu) {
            v = fmaxf(v, 0.0f);
          } else if (a.act != kNone) {
            v = v >= 0.0f ? v : qbf(__fmul_rn(v, ek[n]));
          }
        } else {
          if (has_bias) v = __fadd_rn(v, eb[n]);
          if (a.act == kRelu) {
            v = fmaxf(v, 0.0f);
          } else if (a.act != kNone) {
            v = v >= 0.0f ? v : __fmul_rn(v, ek[n]);
          }
        }
        return v;
      };
      // two neighbours of an output row a 32-bit store: PS 1 phase (py, 0)
      // and (py, 1) of channel n, row segment n, columns 2 pix + {0, 1}; PS 2
      // channels n = 4 c + 2 i + {0, 1} of phase (py, px), segment 2 c + i,
      // columns 2 (2 pix + px) + {0, 1}
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = j * 8 + 2 * tig + (e & 1);
            const int pix = 16 * mt + g + 8 * (e >> 1);
            if constexpr (PS == 1) {
              *reinterpret_cast<__nv_bfloat162*>(obw + n * kSegPad + 2 * pix) =
                  __floats2bfloat162_rn(finish(acc[mt][0][j][e], n),
                                        finish(acc[mt][1][j][e], n));
            } else if ((e & 1) == 0) {
#pragma unroll
              for (int px = 0; px < 2; ++px)
                *reinterpret_cast<__nv_bfloat162*>(
                    obw + ((n >> 2) * 2 + ((n >> 1) & 1)) * kSegPad + 4 * pix + 2 * px) =
                    __floats2bfloat162_rn(finish(acc[mt][px][j][e], n),
                                          finish(acc[mt][px][j][e + 1], n + 1));
            }
          }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int px = 0; px < 2; ++px)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][px][j][e] = 0.0f;
      __syncwarp();
      if (m < a.h) {
        // segment s of the warp: output channel s (PS 1) or s / 2 (PS 2),
        // output row PS (2 m + py) + (s % PS), columns 2 PS x0 + [0, kSeg)
        const int out_ch = a.cout / (PS * PS);
        const int ho = 2 * PS * a.h, wo = 2 * PS * a.w;
        const int x0 = 2 * PS * tx * kTw;
        const bool vec = (wo & 7) == 0;
        const int segs = PS == 1 ? n_valid : n_valid / 2;
        constexpr int kVecs = kSeg / 8;
        for (int idx = lane; idx < segs * kVecs; idx += 32) {
          const int s = idx / kVecs, c0 = 8 * (idx % kVecs);
          const int ch = (g0 / (PS * PS)) + (PS == 1 ? s : s >> 1);
          const int orow = PS * (2 * m + py) + (PS == 1 ? 0 : s & 1);
          const __nv_bfloat16* src = obw + s * kSegPad + c0;
          __nv_bfloat16* dst =
              a.out + ((static_cast<size_t>(b) * out_ch + ch) * ho + orow) * wo + x0 + c0;
          if (vec && x0 + c0 + 8 <= wo) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int k = 0; k < 8 && x0 + c0 + k < wo; ++k) dst[k] = src[k];
          }
        }
      }
      __syncwarp();
    }

    if (more) store_chunk(xs + ((it + 1) & 1) * kBuf, pre);
    cp_async_wait_all();
    __syncthreads();
    chunk = next_chunk;
    t = next_t;
    cur = next;
  }
}

// What the launch needs to know of the calling thread's current device (the
// wrapper's device guard sets it: ops/launch.py), read once per device under
// one lock shared by every host thread that launches.
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

template <int NT, int PS, bool kXla>
cudaError_t launch_dc(DcArgs a, int batch, int n_groups, const DeviceInfo& dev,
                      cudaStream_t s) {
  constexpr int kN = NT * 8;
  constexpr int kSegs = PS == 1 ? kN : kN / 2;  // staged output rows a warp
  const size_t smem = (static_cast<size_t>(2) * 16 * kN * 16 + 2 * kBuf +
                       static_cast<size_t>(kWarps) * kSegs * (32 * kMT * PS + 8)) *
                          sizeof(__nv_bfloat16) +
                      2 * kN * sizeof(float);
  if (smem > static_cast<size_t>(dev.smem_optin)) return cudaErrorInvalidConfiguration;
  static bool done[kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> hold(g_devices_lock);
    if (!done[dev.id]) {
      cudaError_t rc = cudaFuncSetAttribute(deconv4x4_kernel<NT, PS, kXla>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            dev.smem_optin);
      if (rc != cudaSuccess) return rc;
      done[dev.id] = true;
    }
  }
  int per_sm = 0;
  cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, deconv4x4_kernel<NT, PS, kXla>, kThreads, smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  a.tiles_x = (a.w + kTw - 1) / kTw;
  a.tiles_y = (a.h + kRows - 1) / kRows;
  const long long tiles = static_cast<long long>(batch) * a.tiles_x * a.tiles_y;
  if (tiles > (1LL << 30)) return cudaErrorInvalidConfiguration;
  a.n_tiles = static_cast<int>(tiles);
  const int blocks = max(1, per_sm * dev.sms / n_groups);
  dim3 grid(static_cast<unsigned>(min(a.n_tiles, blocks)), static_cast<unsigned>(n_groups));
  deconv4x4_kernel<NT, PS, kXla><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int PS, bool kXla>
cudaError_t dispatch_dc(const DcArgs& a, int batch, int n_groups, const DeviceInfo& dev,
                        cudaStream_t s) {
  switch ((a.group_ch + 7) / 8) {
    case 1: return launch_dc<1, PS, kXla>(a, batch, n_groups, dev, s);
    case 2: return launch_dc<2, PS, kXla>(a, batch, n_groups, dev, s);
    case 3: return launch_dc<3, PS, kXla>(a, batch, n_groups, dev, s);
    default: return cudaErrorInvalidConfiguration;
  }
}

}  // namespace

// C interface.  x (B, cin, h, w) bf16, contiguous; weight_t4 the packed
// (16, cout, cp) bf16 weights (ops/conv.py pack_weight_t4: (phase 2 py + px,
// tap 2 ry + rx), output channel, input channel zero-padded to cp, a
// multiple of 16), 16-byte aligned; bias and slope float32 with at least cout
// values, or null; out (B, cout / ps^2, 2 ps h, 2 ps w) bf16.  ps: 1 or 2.
// xla != 0: the sum is rounded to bf16 before the bias and the activation,
// each in bf16 (bias, slope and alpha must then hold bf16 values); xla == 0:
// f32 bias and activation, one rounding.  Returns cudaGetLastError() right
// after the launch, or the reason the launch was refused.
extern "C" int rife_deconv4x4(const void* x, int cin, const void* weight_t4, int cp,
                              const void* bias, const void* slope, void* out, int batch, int h,
                              int w, int cout, int act, float alpha, int ps, int xla,
                              void* stream) {
  if (cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || batch <= 0 || cp < cin || cp % kChunk ||
      act < kNone || act > kPrelu || (act == kPrelu && slope == nullptr) ||
      (ps != 1 && ps != 2) || cout % (ps * ps) ||
      (reinterpret_cast<uintptr_t>(weight_t4) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo dev;
  const cudaError_t dev_rc = current_device_info(&dev);
  if (dev_rc != cudaSuccess) return static_cast<int>(dev_rc);
  DcArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wt4 = static_cast<const __nv_bfloat16*>(weight_t4);
  a.bias = static_cast<const float*>(bias);
  a.slope = static_cast<const float*>(slope);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.cin = cin;
  a.cp = cp;
  a.h = h;
  a.w = w;
  a.cout = cout;
  a.act = act;
  a.alpha = alpha;
  a.vec_in = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0 ? 1 : 0;
  // groups of at most 24 output channels, whole blocks of ps^2 channels each
  const int blk = ps * ps;
  const int n_groups = (cout + 23) / 24;
  a.group_ch = ((cout / blk) + n_groups - 1) / n_groups * blk;
  if (a.group_ch > 24 || n_groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (ps == 1)
    rc = xla ? dispatch_dc<1, true>(a, batch, n_groups, dev, s)
             : dispatch_dc<1, false>(a, batch, n_groups, dev, s);
  else
    rc = xla ? dispatch_dc<2, true>(a, batch, n_groups, dev, s)
             : dispatch_dc<2, false>(a, batch, n_groups, dev, s);
  return static_cast<int>(rc);
}
