// Hand-written Hopper (sm_90a) kernel for B4's conv form: a 3x3 pad-1 conv,
// stride 1 or 2, over one bf16 input, f32 accumulation, the f32 bias and the
// activation (none, ReLU, leaky, per-channel PReLU) in f32, one rounding to
// bf16, then the DCR PixelShuffle(2): conv channel 4c + 2i + j of conv pixel
// (y, x) goes to output channel c at (2y + i, 2x + j).  The v1 fusionnet's
// head (rife.ConvPS, 16 -> 16 at half resolution) runs it once a step.
// Plain C interface, loaded with ctypes by rife_tpu_torch/native/build.py;
// the wrapper, the tile geometry (ps_geometry) and the plain twin are in
// rife_tpu_torch/ops/conv.py.
//
// Replaces (rife_tpu/ops/conv_planar.py): conv_ps_planar (:756), which runs
// K11 (_conv_planar_s1_direct) with its output channels permuted so that the
// shuffle is a free BHCW reshape.  Here the shuffle is the epilogue's write
// address and the store of one shared-memory output tile.
//
// What bounds it on the H100: at the v1 head (16 -> 16, 544x960, B=8) it
// reads 133.7 MB and writes 133.7 MB (0.0798 ms at 3.35 TB/s) and does 19.25
// GFLOP (0.0195 ms at 989 TFLOP/s): bytes bound it.  Measured (PERF.md
// section 6, tools/conv_ps_probe.py) its loads and stores alone take 0.116
// ms (about 2.3 TB/s) and the transpose, MMAs and epilogue add 0.014 ms.
//
// What the design does about it:
// - Persistent blocks, one an SM: 8 consumer warps and 1 producer warp.  A
//   block walks tiles of TH conv rows x 64 columns x every output channel
//   (TH 8 at 16 output channels; fewer rows for wider outputs, so the output
//   tile and the accumulators keep their size).  Cin <= 64 streams in
//   chunks of 16 channels; each (tile, chunk) is one stage of a ring of 2-4.
//   Consumer warp (rg, cg) owns conv rows rg R .. + R (R = TH / 2) and
//   columns 16 cg .. + 15 of a tile; the warps share nothing but the stages,
//   so no block-wide barrier runs after the setup.
// - Input by TMA (cp.async.bulk.tensor, one mbarrier a stage): one box a
//   window row, 80 columns from x0 - 8 x 16 channels, as NCHW lays them
//   out.  A TMA box's innermost start must be 16-byte aligned (a start at
//   x0 - 1 or x0 + 1 is an illegal instruction on the H100:
//   tools/tma_coord_probe.cu), so the one-column shifts of the 3x3 taps
//   cannot be separate boxes.  The zero fill of out-of-bounds coordinates is
//   the pad (and the channels past Cin).
// - One transpose in shared memory: each warp rewrites its window of a stage
//   (its rows x 32 pixels) channels innermost, [row][pixel][16 channels], 8
//   x 8 blocks at a time, ldmatrix.trans in and stmatrix out; the two
//   16-byte halves of a pixel swap on every other group of 4 pixels, so
//   ldmatrix reads the A fragments (pixel, channel pair) at any pixel shift
//   without bank conflicts.  No input byte passes through registers.
// - Tensor cores: mma.sync m16n8k16, M = 16 conv columns, N = output
//   channels (NT n8 tiles), K = a chunk of 16 input channels.  A warp
//   streams its window's input rows: each row and tap column is one
//   ldmatrix.x4, used by every output row it feeds.  At NT <= 2 the chunk's
//   weights sit in registers (36 at 16 x 16).
// - Sum order, per output: chunk by chunk, taps 0..8 in (ky, kx) order, the
//   order of conv3x3_tc_kernel (csrc/conv.cu): the two are bit for bit, and a
//   pixel's sums depend on nothing but its inputs (not its tile, batch or
//   window).
// - Epilogue: bias, activation and one rounding in registers, by selects (a
//   branch an element cost the kernel a quarter of its time); each thread
//   holds channels (n, n+1) = (4c + 2i, 4c + 2i + 1) of a pixel, which the
//   shuffle puts side by side: one 32-bit store into the warp's output tile
//   (C/4, 2R, 32), then one TMA store of it (its clipping is the ragged
//   edge).  Two output tiles a warp, so one tile's store drains while the
//   next computes.
// - What TMA cannot take (W % 8 != 0; stride 2, since a TMA box has no
//   element stride along its inner dimension; an output width that is not
//   a multiple of 4): the producer warp stages the same rows with
//   per-thread loads (at stride 2 as two planes, the even and the odd
//   columns) and the warps write their tiles with per-thread stores; the
//   transpose, the MMAs and the sum order are the same.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kPrelu = 3 };

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kTw = 64;       // conv columns of a tile
constexpr int kChunk = 16;    // input channels of a stage (the k16 of an MMA)
constexpr int kRawPx = 80;    // pixels of a staged row: columns x0 - 8 .. x0 + 71
constexpr int kRawLine = 2 * kRawPx;          // one (row, channel) line as TMA lands it
constexpr int kRawRow = kChunk * kRawLine;    // one staged row: [channel][80 pixels]
constexpr int kTPx = 32;       // pixels of a warp's transposed row: 16 cg .. + 31
constexpr int kTRow = kTPx * kChunk * 2;      // one transposed row: [32][16]
constexpr int kOutLine = 64;   // bytes of a warp's output line (32 bf16)
constexpr int kWs = 24;        // elements of a staged weight row (16 + skew)
constexpr int kMaxChunks = 4;  // Cin <= 64

// TH conv rows a tile: 16 / NT within [2, 8] at stride 1, 2 at stride 2;
// R = TH / 2 rows a warp (two warps a column group).  A stage holds S
// planes (at stride 2 the even and the odd input columns) of kIn rows.
template <int S, int NT>
struct PsTile {
  static constexpr int kRowsNt = 16 / NT;
  static constexpr int kTh =
      S == 2 ? 2 : (kRowsNt < 2 ? 2 : (kRowsNt > 8 ? 8 : kRowsNt));
  static constexpr int kR = kTh / 2;
  static constexpr int kIn = (kTh - 1) * S + 3;  // input rows of a tile's window
  static constexpr int kWin = (kR - 1) * S + 3;  // input rows a warp reads
  static constexpr int kRows = S * kIn;          // staged rows, planes included
  static constexpr int kStage = kRows * kRawRow;
  static constexpr int kT = S * kWin * kTRow;    // a warp's transposed window
  static constexpr int kN = NT * 8;
  static constexpr bool kWReg = NT <= 2;  // the chunk's weights in registers
};

struct PsArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wtc;  // (9, cout, cp) packed weights
  const float* bias;
  const float* slope;
  __nv_bfloat16* out;
  int cin, cp, h, w, cout, ho, wo, act;
  float alpha;
  int tiles_x, tiles_y, n_tiles, stages, tma_in, tma_out;
  int out_bytes;  // bytes of a warp's output tile: [C/4][2R][32]
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// a warp's transposed window: the 16 bytes of channels 8 half .. 8 half + 7
// of pixel m (row r, pixel l: m = r kTPx + l).  The halves swap on every
// other group of 4 pixels, so the 8 pixels of one ldmatrix or stmatrix row
// group fall on 8 different bank groups (kTPx % 8 == 0 keeps the pattern
// row to row).
__device__ __forceinline__ int tswz(int m, int half) {
  return m * (2 * kChunk) + (((half ^ (m >> 2)) & 1) << 4);
}

// Stage one (tile, chunk) with per-thread loads (the producer warp's 32
// lanes) in the layout a TMA box lands in: [plane][row][channel][80], plane
// p of row rr holding input row S y0 - 1 + rr at columns S (x0 - 8 + q) - p.
template <int S, int NT>
__device__ void stage_by_threads(const PsArgs& a, unsigned char* raw, int b, int y0, int x0,
                                 int chunk, int lane) {
  using Tl = PsTile<S, NT>;
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  constexpr int kJobs = Tl::kRows * kChunk * kRawPx / 2;
  for (int i = lane; i < kJobs; i += 32) {
    const int k = i % (kRawPx / 2), c = (i / (kRawPx / 2)) % kChunk;
    const int row = i / (kRawPx / 2 * kChunk);
    const int ph = row / Tl::kIn, rr = row % Tl::kIn;
    const int ch = chunk * kChunk + c;
    const int gy = y0 * S - 1 + rr;
    uint32_t v = 0;
    if (ch < a.cin && gy >= 0 && gy < a.h) {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(a.x) +
                            (static_cast<size_t>(b) * a.cin + ch) * plane +
                            static_cast<size_t>(gy) * a.w;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gx = S * (x0 - 8 + 2 * k + e) - ph;
        if (gx >= 0 && gx < a.w) v |= static_cast<uint32_t>(src[gx]) << (16 * e);
      }
    }
    *reinterpret_cast<uint32_t*>(raw + (row * kChunk + c) * kRawLine + 4 * k) = v;
  }
}

// Row `row` of a warp's transpose of its window of a stage, [row][channel]
// [80] -> [row][kTPx][16] (tswz): the window is rows rg R S .. + kWin of each
// plane, staged pixels 16 cg .. 16 cg + 31.  Each 8 x 8 block (8 channels
// of 8 pixels) is one ldmatrix.trans row group in and one stmatrix row group
// out: lanes 8m .. 8m + 7 address block m = (pixel block pb + m / 2,
// channel half m % 2).
template <int S, int NT>
__device__ __forceinline__ void transpose_row(const unsigned char* raw, uint32_t tb, int row,
                                              int rg, int cg, int lane) {
  using Tl = PsTile<S, NT>;
  const int r = lane & 7, half = (lane >> 3) & 1, pbo = lane >> 4;
  const int ph = row / Tl::kWin, rr = row % Tl::kWin;
  const unsigned char* src =
      raw + ((ph * Tl::kIn + rg * Tl::kR * S + rr) * kChunk + 8 * half + r) * kRawLine + 32 * cg;
#pragma unroll
  for (int pb = 0; pb < kTPx / 8; pb += 2) {
    uint32_t v[4];
    ldsm_x4_trans(v, smem_u32(src + 16 * (pb + pbo)));
    stsm_x4(tb + tswz(row * kTPx + 8 * (pb + pbo) + r, half), v);
  }
}

template <int S, int NT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_ps_kernel(const __grid_constant__ CUtensorMap in_map,
                  const __grid_constant__ CUtensorMap out_map, PsArgs a) {
  using Tl = PsTile<S, NT>;
  extern __shared__ unsigned char smem_raw[];
  // [stages][kStage] raw stages, [8 warps][kT] transposed windows, [8
  // warps][2][out_bytes] output tiles, the weights, the barriers; 128-byte
  // aligned throughout
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  unsigned char* stages = smem;
  unsigned char* tbuf = stages + a.stages * Tl::kStage;
  unsigned char* obuf = tbuf + kConsumerWarps * Tl::kT;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(obuf + kConsumerWarps * 2 * a.out_bytes);
  const int n_chunks = a.cp / kChunk;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + n_chunks * 9 * Tl::kN * kWs);
  // bars[s]: stage s full; bars[stages + s]: stage s consumed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c4 = a.cout / 4;

  // the weights, [chunk][tap][n][16 + skew], zero past cout
  for (int i = threadIdx.x; i < n_chunks * 9 * Tl::kN * 2; i += kThreads) {
    const int hlf = i & 1, n = (i >> 1) % Tl::kN, ct = (i >> 1) / Tl::kN;
    const int tap = ct % 9, chunk = ct / 9;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < a.cout)
      v = __ldg(reinterpret_cast<const uint4*>(
          a.wtc + (static_cast<size_t>(tap) * a.cout + n) * a.cp + chunk * kChunk + 8 * hlf));
    *reinterpret_cast<uint4*>(ws + (ct * Tl::kN + n) * kWs + 8 * hlf) = v;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_u32(bars + s), a.tma_in ? 1 : 32);
      mbar_init(smem_u32(bars + a.stages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int per_tile = n_chunks;
  const int my_tiles = (a.n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;

  if (warp == kConsumerWarps) {
    // producer: one item a (tile, chunk), a ring of stages
    const int items = my_tiles * per_tile;
    for (int it = 0; it < items; ++it) {
      const int s = it % a.stages, use = it / a.stages;
      const int t = blockIdx.x + (it / per_tile) * gridDim.x, chunk = it % per_tile;
      const int tx = t % a.tiles_x, r0 = t / a.tiles_x;
      const int ty = r0 % a.tiles_y, b = r0 / a.tiles_y;
      const int y0 = ty * Tl::kTh, x0 = tx * kTw;
      const uint32_t full = smem_u32(bars + s), empty = smem_u32(bars + a.stages + s);
      unsigned char* st = stages + s * Tl::kStage;
      if (use > 0) mbar_wait(empty, (use - 1) & 1);
      if (a.tma_in) {
        if (lane == 0) {
          mbar_expect_tx(full, Tl::kStage);
          for (int rr = 0; rr < Tl::kIn; ++rr)
            tma_load(smem_u32(st + rr * kRawRow), &in_map, full, x0 - 8, y0 - 1 + rr,
                     chunk * kChunk, b);
        }
      } else {
        stage_by_threads<S, NT>(a, st, b, y0, x0, chunk, lane);
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumers: warp = (column group cg of 16, row group rg of R rows)
  const int g = lane >> 2, tg = lane & 3;
  const int cg = warp & 3, rg = warp >> 2;
  // ldmatrix.x4: lanes 8m..8m+7 address matrix m's 8 pixel rows (16 bytes,
  // 8 channels each); matrices (pixels 0-7 | 8-15) x (channels 0-7 | 8-15)
  // of the warp's 16 columns give the A fragment (pixel g, channels 2tg,
  // 2tg + 1).  Tap column kx reads staged pixel q = q0 + conv column in
  // plane ph: at stride 1 q0 = 7 + kx, plane 0; at stride 2 the even
  // columns (plane 0) at q0 = 8 for kx = 1 and the odd ones (plane 1) at 8
  // (kx = 0) and 9 (kx = 2).  In the warp's window pixel q is l = q - 16
  // cg.
  const uint32_t tb = smem_u32(tbuf + warp * Tl::kT);
  uint32_t lane_off[3];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    const int ph = S == 1 ? 0 : (kx == 1 ? 0 : 1);
    const int q0 = S == 1 ? 7 + kx : (kx == 2 ? 9 : 8);
    const int l = q0 + 8 * ((lane >> 3) & 1) + (lane & 7);
    lane_off[kx] = tswz(ph * Tl::kWin * kTPx + l, lane >> 4);
  }
  const bool has_bias = a.bias != nullptr;

  // this thread's output channels n = 8j + 2tg (+1): bias and the factor of
  // a negative value (1 without an activation, leaky alpha or the PReLU
  // slope); the epilogue selects, it does not branch
  const bool relu = a.act == kRelu;
  float eb[NT][2], ek[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * tg + e;
      const bool ok = n < a.cout;
      eb[j][e] = ok && has_bias ? a.bias[n] : 0.0f;
      ek[j][e] = !ok || a.act == kNone ? 1.0f : a.act == kPrelu ? a.slope[n] : a.alpha;
    }

  uint32_t wr[Tl::kWReg ? 9 : 1][NT][2];
  float acc[Tl::kR][NT][4];
#pragma unroll
  for (int q = 0; q < Tl::kR; ++q)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.0f;

  int it = 0;
  for (int k = 0; k < my_tiles; ++k) {
    const int t = blockIdx.x + k * gridDim.x;
    for (int chunk = 0; chunk < per_tile; ++chunk, ++it) {
      const int s = it % a.stages;
      if (Tl::kWReg && (it == 0 || per_tile > 1)) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const __nv_bfloat16* wp = ws + ((chunk * 9 + tap) * Tl::kN + 8 * j + g) * kWs + 2 * tg;
            wr[Tl::kWReg ? tap : 0][j][0] = lds32(wp);
            wr[Tl::kWReg ? tap : 0][j][1] = lds32(wp + 8);
          }
      }
      mbar_wait(smem_u32(bars + s), (it / a.stages) & 1);
      // the window of the last stage is read (ldmatrix is warp-synchronous)
#pragma unroll
      for (int row = 0; row < S * Tl::kWin; ++row)
        transpose_row<S, NT>(stages + s * Tl::kStage, tb, row, rg, cg, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(bars + a.stages + s));
#pragma unroll
      for (int rr = 0; rr < Tl::kWin; ++rr) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          uint32_t af[4];
          ldsm_x4(af, tb + lane_off[kx] + rr * kTRow);
#pragma unroll
          for (int q = 0; q < Tl::kR; ++q) {
            const int ky = rr - q * S;
            if (ky < 0 || ky > 2) continue;
            const int tap = ky * 3 + kx;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if constexpr (Tl::kWReg) {
                mma_bf16(acc[q][j], af, wr[tap][j][0], wr[tap][j][1]);
              } else {
                const __nv_bfloat16* wp =
                    ws + ((chunk * 9 + tap) * Tl::kN + 8 * j + g) * kWs + 2 * tg;
                mma_bf16(acc[q][j], af, lds32(wp), lds32(wp + 8));
              }
            }
          }
        }
      }
      if (chunk != per_tile - 1) continue;

      // epilogue: the warp's 16 columns x R rows of tile t into its output
      // tile k % 2, [C/4][2R][32]
      const int tx = t % a.tiles_x, r0 = t / a.tiles_x;
      const int ty = r0 % a.tiles_y, b = r0 / a.tiles_y;
      const int oy = 2 * (ty * Tl::kTh + rg * Tl::kR), ox = 2 * (tx * kTw + 16 * cg);
      unsigned char* ob = obuf + (warp * 2 + (k & 1)) * a.out_bytes;
      if (lane == 0 && a.tma_out)  // the warp's store from two tiles ago has read it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      __syncwarp();
#pragma unroll
      for (int q = 0; q < Tl::kR; ++q) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = 8 * j + 2 * tg;
          const int line = (n >> 2) * 2 * Tl::kR + 2 * q + ((n >> 1) & 1);
#pragma unroll
          for (int hp = 0; hp < 2; ++hp) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float u = acc[q][j][2 * hp + e];
              u = has_bias ? __fadd_rn(u, eb[j][e]) : u;
              const float lin = u >= 0.0f ? u : __fmul_rn(u, ek[j][e]);
              v[e] = relu ? fmaxf(u, 0.0f) : lin;
              acc[q][j][2 * hp + e] = 0.0f;
            }
            if ((n >> 2) < c4)
              *reinterpret_cast<__nv_bfloat162*>(ob + line * kOutLine + 4 * (g + 8 * hp)) =
                  __floats2bfloat162_rn(v[0], v[1]);
          }
        }
      }
      if (a.tma_out) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          if (oy < 2 * a.ho && ox < 2 * a.wo) tma_store(&out_map, smem_u32(ob), ox, oy, 0, b);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
      } else {
        // per-lane stores of bf16 pairs, clipped to the output
        __syncwarp();
        const int wr2 = 2 * a.wo, hr2 = 2 * a.ho;
        for (int i = lane; i < c4 * 2 * Tl::kR * 16; i += 32) {
          const int xw = i % 16, yy = (i / 16) % (2 * Tl::kR), c = i / (32 * Tl::kR);
          const int gy = oy + yy, gx = ox + 2 * xw;
          if (gy >= hr2 || gx >= wr2) continue;
          *reinterpret_cast<uint32_t*>(a.out + ((static_cast<size_t>(b) * c4 + c) * hr2 + gy) *
                                                   wr2 + gx) =
              *reinterpret_cast<const uint32_t*>(ob + (c * 2 * Tl::kR + yy) * kOutLine + 4 * xw);
        }
      }
    }
  }
  if (lane == 0 && a.tma_out) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// a 4-d bf16 map over (x, y, c, b) = (d0, d1, d2, d3), dense, box (box_x,
// rows, channels, 1), out-of-bounds elements zero
cudaError_t encode_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int d3,
                       int box_x, int box_rows, int box_ch, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * d2 * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_x), static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(box_ch), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int S, int NT>
cudaError_t launch_ps(PsArgs a, int batch, int tile_rows, const DeviceInfo& dev,
                      cudaStream_t s) {
  using Tl = PsTile<S, NT>;
  if (tile_rows != Tl::kTh || a.stages < 2 || a.stages > 4 || (a.tma_in && S != 1))
    return cudaErrorInvalidValue;
  const int n_chunks = a.cp / kChunk;
  const int c4 = a.cout / 4;
  a.out_bytes = (c4 * 2 * Tl::kR * kOutLine + 127) / 128 * 128;
  const size_t smem = 128 + static_cast<size_t>(a.stages) * Tl::kStage +
                      kConsumerWarps * (Tl::kT + 2 * a.out_bytes) +
                      static_cast<size_t>(n_chunks) * 9 * Tl::kN * kWs * 2 + 2 * a.stages * 8;
  if (smem > static_cast<size_t>(dev.smem_optin)) return cudaErrorInvalidConfiguration;
  static bool done[kMaxDevices] = {};
  {
    std::lock_guard<std::mutex> hold(g_devices_lock);
    if (!done[dev.id]) {
      cudaError_t rc = cudaFuncSetAttribute(
          conv3x3_ps_kernel<S, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, dev.smem_optin);
      if (rc != cudaSuccess) return rc;
      done[dev.id] = true;
    }
  }
  a.tiles_x = (a.wo + kTw - 1) / kTw;
  a.tiles_y = (a.ho + Tl::kTh - 1) / Tl::kTh;
  const long long tiles = static_cast<long long>(batch) * a.tiles_x * a.tiles_y;
  if (tiles > (1LL << 30)) return cudaErrorInvalidConfiguration;
  a.n_tiles = static_cast<int>(tiles);
  CUtensorMap in_map{}, out_map{};
  cudaError_t rc = cudaSuccess;
  if (a.tma_in)
    rc = encode_map(&in_map, a.x, a.w, a.h, a.cin, batch, kRawPx, 1, kChunk,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == cudaSuccess && a.tma_out)
    rc = encode_map(&out_map, a.out, 2 * a.wo, 2 * a.ho, c4, batch, kOutLine / 2, 2 * Tl::kR,
                    c4, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != cudaSuccess) return rc;
  const int grid = a.n_tiles < dev.sms ? a.n_tiles : dev.sms;
  conv3x3_ps_kernel<S, NT><<<grid, kThreads, smem, s>>>(in_map, out_map, a);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch_ps(const PsArgs& a, int batch, int tile_rows, const DeviceInfo& dev,
                        cudaStream_t s) {
  switch ((a.cout + 7) / 8) {
    case 1: return launch_ps<S, 1>(a, batch, tile_rows, dev, s);
    case 2: return launch_ps<S, 2>(a, batch, tile_rows, dev, s);
    case 3:
    case 4: return launch_ps<S, 4>(a, batch, tile_rows, dev, s);
    case 5:
    case 6:
    case 7:
    case 8: return launch_ps<S, 8>(a, batch, tile_rows, dev, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface.  x (B, cin, h, w) bf16, contiguous, 16-byte aligned; weight_tc
// the packed (9, cout, cp) bf16 weights of conv3x3_tc_kernel (ops/conv.py
// pack_weight_tc), cp = cin rounded up to 16, 16-byte aligned; bias and slope
// float32 (cout,) or null; out (B, cout / 4, 2 Ho, 2 Wo) bf16, 16-byte
// aligned, Ho = (h - 1) / stride + 1.  cin <= 64, cout <= 64 and a multiple
// of 4.  The geometry is the caller's (ops/conv.py ps_geometry): tile_rows
// conv rows a tile (checked against the kernel's), stages 2 to 4, tma_in
// (stride 1 and w % 8 == 0 only) and tma_out (2 Wo % 8 == 0) choose the TMA
// or the per-thread branch.  Returns cudaGetLastError() right after the
// launch, or the reason the launch was refused.
extern "C" int rife_conv3x3_ps(const void* x, int cin, const void* weight_tc, int cp,
                               const void* bias, const void* slope, void* out, int batch, int h,
                               int w, int cout, int stride, int act, float alpha, int tile_rows,
                               int stages, int tma_in, int tma_out, void* stream) {
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  if (cin <= 0 || cin > kMaxChunks * kChunk || cout <= 0 || cout > 64 || cout % 4 ||
      h <= 0 || w <= 0 || batch <= 0 || cp < cin || cp % kChunk || cp > kMaxChunks * kChunk ||
      (stride != 1 && stride != 2) || act < kNone || act > kPrelu ||
      (act == kPrelu && slope == nullptr) || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(weight_tc) & 15) || (reinterpret_cast<uintptr_t>(out) & 15) ||
      (tma_in && w % 8) || (tma_out && wo % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo dev;
  const cudaError_t dev_rc = current_device_info(&dev);
  if (dev_rc != cudaSuccess) return static_cast<int>(dev_rc);
  PsArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wtc = static_cast<const __nv_bfloat16*>(weight_tc);
  a.bias = static_cast<const float*>(bias);
  a.slope = static_cast<const float*>(slope);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.cin = cin;
  a.cp = cp;
  a.h = h;
  a.w = w;
  a.cout = cout;
  a.ho = ho;
  a.wo = wo;
  a.act = act;
  a.alpha = alpha;
  a.stages = stages;
  a.tma_in = tma_in ? 1 : 0;
  a.tma_out = tma_out ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = stride == 1 ? dispatch_ps<1>(a, batch, tile_rows, dev, s)
                                     : dispatch_ps<2>(a, batch, tile_rows, dev, s);
  return static_cast<int>(rc);
}
