// Hand-written Hopper (sm_90a) kernel for the planar conv sites of the
// rife-v2.3 plain 2x path: a 3x3 pad-1 conv, stride 1 or 2, over the channel
// concat of 1-4 input parts, with the f32 bias, the activation (none, ReLU,
// leaky, per-channel PReLU) in f32 and one rounding to the storage dtype.
// Plain C interface, loaded with ctypes by rife_tpu_torch/native/build.py; the
// PyTorch wrapper, the plain twin and the site gates are in
// rife_tpu_torch/ops/conv.py.
//
// Replaces (rife_tpu/ops/conv_planar.py):
//   stride 1  _conv_planar_s1_direct -> _conv_s1_direct_kernel (K11; also the
//             base of deconv_planar: the 4x4 stride-2 deconv runs as one
//             stride-1 conv over its four output phases);
//             conv_planar_bhcw -> _conv_planar_kernel (K9) computes the same
//   stride 2  _conv_planar_s2_direct_cat / _conv_planar_s2_direct ->
//             _conv_s2_direct_kernel (K12), parts read in place, the concat
//             never built; conv_s2_bhcw -> _conv_s2_kernel (K10) computes the
//             same
//
// What bounds it on the H100: the gated sites are narrow (min(Cin, Cout) <=
// 32, at most 128 channels) at up to full 1088x1920 resolution.  A 32->32
// stride-1 conv at 544x960, B=16, is 77 GMAC against ~1.1 GB of activations
// (bf16 in and out), ~70 MAC per byte: above the CUDA cores' balance point
// (~10 FMA/B at 33.5 TFMA/s and 3.35 TB/s), below the tensor cores'.  This
// first kernel runs on the CUDA cores (f32 FMA), so arithmetic bounds it;
// wgmma, TMA and tuning are later work.
//
// What the design does about it: a block computes a 32-wide output tile of
// 32 rows (stride 1) or 16 rows (stride 2) for 16 output channels; 256
// threads, each one output column, 4 (or 2) output rows and the 16 channels,
// 64 (or 32) f32 accumulators in registers.  Input channels stream through
// shared memory in stages of 8 (stride 1) or 4 (stride 2): the input tile with
// its halo, zero-filled outside the frame (the pad), converted to f32, and the
// stage's 3x3 weights laid out [ci][tap][co] so a thread reads its 16 weights
// of a tap as four float4 broadcasts.  Per stage and input channel a thread
// loads its 3-column window once and reuses each value across the 16 output
// channels (576 FMAs per 18 input and 36 weight loads at stride 1).  Each
// stage channel resolves to its part's plane once (the part pointers and
// channel counts arrive by value), so ConvolutionCat never builds the concat.
// The epilogue adds the f32 bias, applies the activation in f32 with _rn
// products and rounds once, as _apply_act does before the kernel's astype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxParts = 4;
constexpr int kTx = 32;  // threads along x, one output column each
constexpr int kTy = 8;   // threads along y
constexpr int kCo = 16;  // output channels per block (registers per thread)

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kPrelu = 3 };

struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];
};

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T store(float v);
template <> __device__ __forceinline__ float store<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float activate(float v, int act, float alpha, float slope) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.0f);
    case kLeaky: return v >= 0.0f ? v : __fmul_rn(v, alpha);
    case kPrelu: return v >= 0.0f ? v : __fmul_rn(v, slope);
    default: return v;
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kTx * kTy)
conv3x3_kernel(Parts parts, const T* __restrict__ weight, const float* __restrict__ bias,
               const float* __restrict__ slope, T* __restrict__ out, int cin, int h, int w,
               int cout, int ho, int wo, int act, float alpha, int n_groups) {
  using Tl = Tile<S>;
  __shared__ float xs[Tl::kCi][Tl::kIh][Tl::kIw];
  __shared__ __align__(16) float ws[Tl::kCi][9][kCo];
  __shared__ const T* chan[Tl::kCi];

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
    // the stage's channels -> their planes in the parts (null past cin)
    if (tid < Tl::kCi) {
      const T* plane_ptr = nullptr;
      int c = ci0 + tid;
      if (c < cin) {
        for (int k = 0; k < kMaxParts; ++k) {
          if (c < parts.ch[k]) {
            plane_ptr = static_cast<const T*>(parts.ptr[k]) +
                        (static_cast<size_t>(b) * parts.ch[k] + c) * plane;
            break;
          }
          c -= parts.ch[k];
        }
      }
      chan[tid] = plane_ptr;
    }
    __syncthreads();

    // input tile with halo, zero outside the frame and past cin
    constexpr int kTileN = Tl::kCi * Tl::kIh * Tl::kIw;
    for (int i = tid; i < kTileN; i += kTx * kTy) {
      const int ci = i / (Tl::kIh * Tl::kIw);
      const int r = (i / Tl::kIw) % Tl::kIh;
      const int c = i % Tl::kIw;
      const int gy = iy0 + r, gx = ix0 + c;
      const T* src = chan[ci];
      float v = 0.0f;
      if (src != nullptr && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = to_f(__ldg(src + static_cast<size_t>(gy) * w + gx));
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
        v = to_f(__ldg(weight + (static_cast<size_t>(gco) * cin + gci) * 9 + tap));
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
      float v = acc[p][c];
      if (bias != nullptr) v = __fadd_rn(v, bias[co]);
      v = activate(v, act, alpha, slope != nullptr ? slope[co] : 0.0f);
      out[((static_cast<size_t>(b) * cout + co) * ho + oy) * wo + ox] = store<T>(v);
    }
  }
}

template <typename T, int S>
cudaError_t launch(const Parts& parts, const void* weight, const float* bias,
                   const float* slope, void* out, int batch, int cin, int h, int w, int cout,
                   int act, float alpha, cudaStream_t s) {
  using Tl = Tile<S>;
  const int ho = (h - 1) / S + 1, wo = (w - 1) / S + 1;
  const int groups = (cout + kCo - 1) / kCo;
  const long long z = static_cast<long long>(batch) * groups;
  if (z > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((wo + Tl::kOw - 1) / Tl::kOw, (ho + Tl::kOh - 1) / Tl::kOh,
            static_cast<unsigned>(z));
  dim3 block(kTx, kTy);
  conv3x3_kernel<T, S><<<grid, block, 0, s>>>(parts, static_cast<const T*>(weight), bias,
                                               slope, static_cast<T*>(out), cin, h, w, cout,
                                               ho, wo, act, alpha, groups);
  return cudaGetLastError();
}

}  // namespace

// C interface.  Parts x0..x3: contiguous NCHW (B,c_i,H,W) in one dtype (bf16 !=
// 0 -> __nv_bfloat16, else float), unused parts null with c_i = 0; weight
// (cout, sum c_i, 3, 3) in that dtype; bias and slope float32 (cout,) or null;
// out (B, cout, Ho, Wo), Ho = (H-1)/stride + 1.  Returns cudaGetLastError()
// right after the launch.
extern "C" int rife_conv3x3(const void* x0, const void* x1, const void* x2, const void* x3,
                            int c0, int c1, int c2, int c3, const void* weight,
                            const void* bias, const void* slope, void* out, int batch, int h,
                            int w, int cout, int stride, int act, float alpha, int bf16,
                            void* stream) {
  const Parts parts = {{x0, x1, x2, x3}, {c0, c1, c2, c3}};
  const int cin = c0 + c1 + c2 + c3;
  if (cin <= 0 || cout <= 0 || (stride != 1 && stride != 2) || act < kNone ||
      act > kPrelu || (act == kPrelu && slope == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const float* sl = static_cast<const float*>(slope);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (bf16) {
    rc = stride == 1
             ? launch<__nv_bfloat16, 1>(parts, weight, b, sl, out, batch, cin, h, w, cout,
                                        act, alpha, s)
             : launch<__nv_bfloat16, 2>(parts, weight, b, sl, out, batch, cin, h, w, cout,
                                        act, alpha, s);
  } else {
    rc = stride == 1 ? launch<float, 1>(parts, weight, b, sl, out, batch, cin, h, w, cout,
                                        act, alpha, s)
                     : launch<float, 2>(parts, weight, b, sl, out, batch, cin, h, w, cout,
                                        act, alpha, s);
  }
  return static_cast<int>(rc);
}
