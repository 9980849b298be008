// The tile geometry and the launch plan of conv.cu's f32 kernel
// (conv3x3_f32_kernel): the kernel and its launch (rife_conv3x3) read them
// from here and nowhere else.  Plain C++ with no CUDA in it, so a host
// compiler builds it too: tests/test_torch_conv_f32.py compiles it with g++
// and walks the plan, the tiles, the chunks and the warps' shares of a tile
// as the kernel walks them.
#pragma once

#ifdef __CUDACC__
#define RIFE_F32_HD __host__ __device__ __forceinline__
#else
#define RIFE_F32_HD inline
#endif

namespace rife_f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupCh = 16;     // a tile holds WC x 16 channels (deconv: phase channels)
constexpr int kTileCols = 32;    // output columns of a tile, a lane each
constexpr int kMaxStageCh = 16;  // input channels a stage holds at most
// a block's shared memory when two share an SM (228 KB, 1 KB reserved a block)
constexpr int kSmemBlock = 113 * 1024;

// output rows a thread: a tile is 16 rows of 8 / (2 WC) warps (conv) or
// 8 / WC warps (deconv)
constexpr int rows_per_thread(bool deconv, int wc) { return deconv ? 2 * wc : 4 * wc; }

// The tile of one block: WC x 16 channels, 8 warps as kWr row groups x
// kWc channel groups; a warp computes 32 output columns (a lane each) x R
// output rows x kCw tile channels: 8 for a conv (two float4 weight loads
// feed a tap's 8 R FMAs), 16 for a deconv (four phases of 4 channels).  A
// staged input channel is kIh rows x kIw columns from input column ox0 * S
// - 4 (16-byte aligned rows: four columns a 16-byte copy), so input column
// ox0 * S - 1 + c sits at kX + c.
template <int S, int WC, bool DECONV>
struct Tile {
  static constexpr int R = rows_per_thread(DECONV, WC);
  static constexpr int kCt = WC * kGroupCh;             // channels of a tile
  static constexpr int kCw = DECONV ? 16 : 8;           // tile channels of a warp
  static constexpr int kWc = kCt / kCw;                 // warps along the channels
  static constexpr int kWr = kWarps / kWc;              // warps along the rows
  static constexpr int kRows = kWr * R;                 // output rows of a tile
  static constexpr int kIh = (kRows - 1) * S + 3;       // staged input rows
  static constexpr int kIw = S == 1 ? 40 : 68;          // staged input columns
  static constexpr int kVecs = kIw / 4;                 // 16-byte copies a row
  static constexpr int kX = 3;
  static constexpr int kTaps = DECONV ? 4 : 9;          // weight rows of a channel
  static constexpr int kIn = kIh * kIw;                 // floats of a staged channel
  static constexpr int kWin = (R - 1) * S + 3;          // rows of a thread's window
  static constexpr int kOutCh = DECONV ? 4 : kCw;       // output channels of a warp
  static constexpr int kGroupOut = DECONV ? 4 * WC : kCt;  // output channels of a group
};

// A warp's share of its tile: output rows warp_row0 .. + R - 1 of the
// tile and output channels warp_ch0 .. + out_ch - 1 of its group (deconv:
// each in its four phases), over all 32 columns
RIFE_F32_HD int warp_row0(int warp, int wr, int r) { return (warp % wr) * r; }
RIFE_F32_HD int warp_ch0(int warp, int wr, int out_ch) { return (warp / wr) * out_ch; }

struct TileAt {
  int b, oy0, ox0;
};

// tile t of a channel group: batch item, first output row and column
RIFE_F32_HD TileAt tile_at(int t, int tiles_x, int tiles_y, int rows) {
  const int tx = t % tiles_x, r0 = t / tiles_x;
  return TileAt{r0 / tiles_y, (r0 % tiles_y) * rows, tx * kTileCols};
}

// tiles of a group that block `block` of `blocks` walks: block, block +
// blocks, ... below n_tiles
RIFE_F32_HD int block_tiles(int n_tiles, int block, int blocks) {
  return (n_tiles - 1 - block) / blocks + 1;
}

// first input channel of chunk k: the chunks split cin as evenly as they can
RIFE_F32_HD int chunk_start(int k, int cin, int n) { return k * cin / n; }

// floats of a stage's input rows, rounded up so that what follows starts
// 16-byte aligned
RIFE_F32_HD int stage_in_floats(int kc, int in_floats) { return (kc * in_floats + 3) / 4 * 4; }

// One launch: groups (blockIdx.y) of group_out output channels, each over
// n_tiles tiles of rows x 32 outputs (tiles_x x tiles_y a batch item); the
// input channels staged n_chunks at a time (at most kc each) through two
// buffers; the group's weights resident in shared memory
// where they fit beside two stages in kSmemBlock (two blocks an SM), else
// each stage carries its chunk's; smem bytes in all.  r, wr, out_ch: the
// warps' shares (warp_row0, warp_ch0).
struct Plan {
  int wc, rows, groups, group_out, tiles_x, tiles_y, n_tiles;
  int kc, n_chunks, resident, smem;
  int r, wr, out_ch;
};

template <int S, int WC, bool DECONV>
inline void plan_with(Plan* p, int cin, int cout, int ho, int wo) {
  using Tl = Tile<S, WC, DECONV>;
  const int w_ch = Tl::kTaps * Tl::kCt;  // weight floats an input channel
  const int budget = kSmemBlock / 4 - 8;  // floats; each stage's input rounds up by < 4
  p->wc = WC;
  p->rows = Tl::kRows;
  p->r = Tl::R;
  p->wr = Tl::kWr;
  p->out_ch = Tl::kOutCh;
  p->group_out = Tl::kGroupOut;
  p->groups = (cout + Tl::kGroupOut - 1) / Tl::kGroupOut;
  p->tiles_x = (wo + kTileCols - 1) / kTileCols;
  p->tiles_y = (ho + Tl::kRows - 1) / Tl::kRows;
  p->resident = cin * w_ch + 2 * Tl::kIn <= budget;
  int kc = p->resident ? (budget - cin * w_ch) / (2 * Tl::kIn) : budget / (2 * (Tl::kIn + w_ch));
  kc = kc < kMaxStageCh ? kc : kMaxStageCh;
  kc = kc < cin ? kc : cin;
  p->kc = kc > 1 ? kc : 1;
  p->n_chunks = (cin + p->kc - 1) / p->kc;
  const int stage = stage_in_floats(p->kc, Tl::kIn) + (p->resident ? 0 : p->kc * w_ch);
  p->smem = 4 * ((p->resident ? cin * w_ch : 0) + 2 * stage);
}

// The plan of a launch over batch x (cin, h, w) inputs and cout output
// channels (deconv: the transposed conv's O, at stride 1 on the input
// grid): tiles of 32 channels where the channels fill an even number of 16
// (deconv: of 4 channels x 4 phases), else 16.  False where the kernel
// does not take the launch.
inline bool plan(int batch, int cin, int cout, int h, int w, int stride, bool deconv, Plan* p) {
  if (batch <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || cin > (1 << 16) ||
      (stride != 1 && stride != 2) || (deconv && stride != 1))
    return false;
  const int per_group = deconv ? 4 : kGroupCh;
  const bool wide = (cout + per_group - 1) / per_group % 2 == 0;
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  if (deconv)
    wide ? plan_with<1, 2, true>(p, cin, cout, ho, wo) : plan_with<1, 1, true>(p, cin, cout, ho, wo);
  else if (stride == 1)
    wide ? plan_with<1, 2, false>(p, cin, cout, ho, wo) : plan_with<1, 1, false>(p, cin, cout, ho, wo);
  else
    wide ? plan_with<2, 2, false>(p, cin, cout, ho, wo) : plan_with<2, 1, false>(p, cin, cout, ho, wo);
  const long long tiles = static_cast<long long>(batch) * p->tiles_x * p->tiles_y;
  if (p->groups > 65535 || tiles > (1LL << 30)) return false;
  p->n_tiles = static_cast<int>(tiles);
  return true;
}

}  // namespace rife_f32
