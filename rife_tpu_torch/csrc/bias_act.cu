// Hand-written Hopper (sm_90a) kernel for the epilogue of the convolutions
// that run on the library (cuDNN): the per-channel bias and the fused
// activation, in place, in one pass.  Plain C interface, loaded with ctypes
// by rife_tpu_torch/native/build.py; the PyTorch wrapper (bias_act) and its
// plain twin (bias_act_ref) are in rife_tpu_torch/ops/conv.py.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias and the activation
// into the convolution.  On the card, F.conv2d with a bias runs cuDNN and
// then a broadcast add of the bias, a pass of its own, and the eager
// activation takes three more (leaky / PReLU: y >= 0, y * s, where), each
// reading and writing the whole conv output.  This kernel computes the same
// bits in one read and one write, after a conv called without the bias.
//
// The function, per element of a contiguous NCHW tensor y of storage type T
// (bf16 or f32), channel c, with the bias and slope holding T's values as
// float32 (the XLA order of ROADMAP trap 7: the sum rounded before the bias):
//   t = rn_T(float(y) + bias[c])                     (no bias: t = y)
//   none:  t
//   ReLU:  isnan(t) ? t : max(t, 0)                  (torch.clamp_min)
//   leaky: t >= 0 ? t : rn_T(float(t) * alpha)       (alpha a T value)
//   PReLU: t >= 0 ? t : rn_T(float(t) * slope[c])
// rn_T is __float2bfloat16_rn for bf16 (what c10::BFloat16 uses on sm_80 and
// up) and nothing for f32, so -0.0 stays -0.0 and each product is rounded
// once, as PyTorch's elementwise kernels round them.
//
// What bounds it on the H100: bytes.  It reads and writes y once, 2 x the
// tensor's bytes over 3.35 TB/s: at v4.6's res3 sites (64 x 272 x 480, B=8,
// bf16) 0.267 GB, 0.080 ms.  It does a few flops an element.
//
// What the design does about it:
// - A block walks a run of one (b, c) plane, so the bias and the slope are
//   one register each a block and no thread divides an element index.
//   grid.x is the planes, grid.y the runs of a plane.
// - 16-byte loads and stores, 8 bf16 or 4 f32 a thread, where the plane's
//   size is a multiple of the vector and the base is 16-byte aligned (every
//   site of the 1080p steps: 34 x 60 up to 544 x 960); a scalar path for
//   the rest.  Each thread keeps kUnroll vectors in flight: a block moves
//   16 KB a pass.
// - A run is one pass (8,192 bf16 values) unless a plane would need more
//   than 65,535 runs, so even the smallest site (192 x 34 x 60 at B=8:
//   1,536 planes) fills the 132 SMs several times over.
// - No shared memory, no synchronisation, no allocation; it launches on the
//   caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kPrelu = 3 };

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kMaxRuns = 65535;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int ACT, bool BIAS>
__device__ __forceinline__ T epilogue(T y, float b, float s) {
  const T t = BIAS ? from_f<T>(to_f(y) + b) : y;
  const float tf = to_f(t);
  if (ACT == kRelu) return isnan(tf) ? t : from_f<T>(fmaxf(tf, 0.0f));
  if (ACT == kLeaky || ACT == kPrelu) return tf >= 0.0f ? t : from_f<T>(tf * s);
  return t;
}

// V values of T a thread an access (V = 16 / sizeof(T) on the vector path, 1
// on the scalar path); a block covers [run * run_len, (run + 1) * run_len) of
// its plane, run_len a multiple of kThreads * kUnroll * V.
template <typename T, int ACT, bool BIAS, int V>
__global__ void __launch_bounds__(kThreads)
    bias_act_kernel(T* __restrict__ y, const float* __restrict__ bias,
                    const float* __restrict__ slope, int channels, long long hw,
                    long long run_len, float alpha) {
  using Vec = typename std::conditional<V == 1, T, uint4>::type;
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const float b = BIAS ? bias[c] : 0.0f;
  const float s = ACT == kPrelu ? slope[c] : alpha;
  T* p = y + plane * hw;
  const long long start = static_cast<long long>(blockIdx.y) * run_len;
  const long long end = start + run_len < hw ? start + run_len : hw;
  constexpr long long kStep = static_cast<long long>(kThreads) * V;
  for (long long base = start + threadIdx.x * V; base < end; base += kStep * kUnroll) {
    Vec v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kStep;
      if (i < end) v[u] = *reinterpret_cast<const Vec*>(p + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      T* e = reinterpret_cast<T*>(&v[u]);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = epilogue<T, ACT, BIAS>(e[k], b, s);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kStep;
      if (i < end) *reinterpret_cast<Vec*>(p + i) = v[u];
    }
  }
}

template <typename T, int ACT, bool BIAS, int V>
cudaError_t launch(T* y, const float* bias, const float* slope, int planes, int channels,
                   long long hw, float alpha, cudaStream_t stream) {
  const long long pass = static_cast<long long>(kThreads) * kUnroll * V;
  long long passes = 1;
  while ((hw + pass * passes - 1) / (pass * passes) > kMaxRuns) ++passes;
  const long long run_len = pass * passes;
  const dim3 grid(static_cast<unsigned>(planes),
                  static_cast<unsigned>((hw + run_len - 1) / run_len));
  bias_act_kernel<T, ACT, BIAS, V>
      <<<grid, kThreads, 0, stream>>>(y, bias, slope, channels, hw, run_len, alpha);
  return cudaGetLastError();
}

template <typename T, int ACT, bool BIAS>
cudaError_t pick_width(T* y, const float* bias, const float* slope, int planes, int channels,
                       long long hw, float alpha, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (hw % kVec == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0)
    return launch<T, ACT, BIAS, kVec>(y, bias, slope, planes, channels, hw, alpha, stream);
  return launch<T, ACT, BIAS, 1>(y, bias, slope, planes, channels, hw, alpha, stream);
}

template <typename T, int ACT>
cudaError_t pick_bias(T* y, const float* bias, const float* slope, int planes, int channels,
                      long long hw, float alpha, cudaStream_t stream) {
  if (bias != nullptr)
    return pick_width<T, ACT, true>(y, bias, slope, planes, channels, hw, alpha, stream);
  return pick_width<T, ACT, false>(y, bias, slope, planes, channels, hw, alpha, stream);
}

template <typename T>
cudaError_t pick_act(void* y, const float* bias, const float* slope, int planes, int channels,
                     long long hw, int act, float alpha, cudaStream_t stream) {
  T* t = static_cast<T*>(y);
  switch (act) {
    case kRelu:
      return pick_bias<T, kRelu>(t, bias, slope, planes, channels, hw, alpha, stream);
    case kLeaky:
      return pick_bias<T, kLeaky>(t, bias, slope, planes, channels, hw, alpha, stream);
    case kPrelu:
      return pick_bias<T, kPrelu>(t, bias, slope, planes, channels, hw, alpha, stream);
    default:
      return pick_bias<T, kNone>(t, bias, slope, planes, channels, hw, alpha, stream);
  }
}

}  // namespace

extern "C" {

// y: contiguous (B, C, H, W) of bf16 (bf16 != 0) or f32, rewritten in place;
// bias, slope: C float32 values each (null: no bias; slope only for PReLU),
// holding values of y's type; planes = B * C; hw = H * W; act as in
// ops/conv.py (0 none, 1 ReLU, 2 leaky, 3 PReLU); alpha the leaky slope, a
// value of y's type.
int rife_bias_act(void* y, int bf16, const void* bias, const void* slope, int planes,
                  int channels, long long hw, int act, float alpha, void* stream) {
  if (y == nullptr || planes <= 0 || channels <= 0 || planes % channels || hw <= 0 ||
      act < kNone || act > kPrelu || (act == kPrelu && slope == nullptr) ||
      (act == kNone && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(slope);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return static_cast<int>(pick_act<__nv_bfloat16>(y, b, s, planes, channels, hw, act, alpha, st));
  return static_cast<int>(pick_act<float>(y, b, s, planes, channels, hw, act, alpha, st));
}

}  // extern "C"
