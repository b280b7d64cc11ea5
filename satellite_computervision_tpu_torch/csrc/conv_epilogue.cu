// conv_epilogue: the served U-Net's per-channel epilogues, one pass each.
//
// Replaces no TPU kernel. On the TPU, XLA fused each conv's bias add and
// ReLU, the encoder's 2x2 max-pool, and the decoder's concatenation,
// folded-BatchNorm affine and ReLU, into the convs' outputs
// (satellite_computervision_tpu/models/blocks.py: ConvBNAct, EncoderBlock,
// DecoderBlock with fold_bn). In eager PyTorch each is its own pass over
// the activation: cuDNN's output gets its bias in a broadcast add that a
// channels-last tensor cannot vectorise, then ReLU writes a new tensor;
// max_pool2d reads that tensor again and writes an int64 index beside every
// output; the decoder concatenates, multiplies, adds and rectifies in four
// passes. Those passes, not the convs, took most of the served U-Net's
// device time.
//
// What it computes, on channels-last (NHWC) bfloat16 or float32
// activations, channel c of a flat offset being offset % C:
// - bias_relu (in place): y = relu(round(y + b[c]));
// - bias_relu_pool: bias_relu, then pooled (B, C, H/2, W/2) from the
//   rectified y: pooled[i, j] = the max of y[2i, 2j], y[2i, 2j+1],
//   y[2i+1, 2j], y[2i+1, 2j+1], scanned in that order in float from -inf,
//   taking v where v > max or v is NaN, as ATen's max-pool scans a window:
//   a NaN propagates and the first of -0 and +0 stays;
// - cat_affine_relu: out (B, Cs + Cu, H, W) from skip (B, Cs, H, W) and the
//   transposed conv's output without its bias, up (B, Cu, H, W):
//   v = skip[c] for c < Cs, else round(up[c - Cs] + ub[c - Cs]);
//   out[c] = relu(round(round(v * s[c]) + t[c])).
// ``round`` is to the tensor's type. Each sum and product is taken in
// float32 and rounded on its own (__fadd_rn, __fmul_rn: no FMA
// contraction), and relu passes NaN through and is fmaxf(x, 0) otherwise:
// what PyTorch's add, mul and clamp_min kernels compute, so the output is
// bit-equal to the unfused ops.
//
// What bounds it: bytes. bias_relu reads and writes the activation once;
// bias_relu_pool does too and writes a quarter of it more, with no indices;
// cat_affine_relu reads skip and up once and writes the concatenation once.
// At the sweep's largest site (16 x 640^2 x 32 bf16) bias_relu moves
// 2 x 419 MB: 0.250 ms at the H100's 3.35 TB/s; bias_relu_pool 943 MB:
// 0.282 ms.
//
// What the design does about it. Each thread moves 16-byte vectors (8 bf16
// or 4 float32 values) and issues all of its kUnroll loads before its first
// store. C a multiple of 8 keeps a vector inside one pixel and, for the
// concatenation, inside one source. A block holds a whole number of pixels'
// channel vectors, so a thread's channel slot, and with it its bias, scale
// and shift values, is the same for every vector it moves: they are read
// once into registers. No division per vector, no shared memory.
// bias_relu_pool keeps that layout on a 2-D grid: a block row covers
// pooled pixels of one pooled row side by side, a thread one channel vector
// of a 2x2 quad. Its four loads go out before any store, and the
// horizontal pair of a quad is one 2C-element span, so a warp's loads of
// one input row cover contiguous memory; the max is taken in registers.
// One quad a thread (four vectors in flight, as bias_relu's kUnroll): in bf16 two
// or four spilled under the 64 registers that blocks of 1024 threads leave
// and ran at half and a quarter of the speed on the H100.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kUnroll = 4;      // vectors a thread moves
constexpr int kThreads = 256;   // a block's threads, rounded down to whole pixels
constexpr int kMaxSlots = 1024; // channel vectors of a pixel a block can hold

template <typename T>
struct Lanes {
  static constexpr int n = 16 / sizeof(T);
};

template <typename T>
struct alignas(16) Pack {
  T v[Lanes<T>::n];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) { return from_f<T>(__fadd_rn(to_f(a), to_f(b))); }

template <typename T>
__device__ __forceinline__ T mul(T a, T b) { return from_f<T>(__fmul_rn(to_f(a), to_f(b))); }

// clamp_min(x, 0) as PyTorch computes it: a NaN is returned as it is
template <typename T>
__device__ __forceinline__ T relu(T x) {
  const float f = to_f(x);
  return isnan(f) ? x : from_f<T>(fmaxf(f, 0.0f));
}

// blockDim.x is a multiple of ``slots`` (channel vectors a pixel): thread t
// moves channel vector t % slots of pixels p0, p0 + ppb, ... (ppb pixels a
// block row)
struct Tiling {
  int slot;
  int64_t p0;
  int ppb;
};

__device__ __forceinline__ Tiling tiling(int slots) {
  const int ppb = blockDim.x / slots;
  return {static_cast<int>(threadIdx.x % slots),
          static_cast<int64_t>(blockIdx.x) * ppb * kUnroll + threadIdx.x / slots, ppb};
}

// Both kernels take blocks of up to kMaxSlots threads: their registers are
// capped to fit.
template <typename T>
__global__ void __launch_bounds__(kMaxSlots)
    bias_relu_kernel(T* __restrict__ y, const T* __restrict__ bias, int64_t pixels, int slots) {
  constexpr int N = Lanes<T>::n;
  const Tiling t = tiling(slots);
  T b[N];
#pragma unroll
  for (int k = 0; k < N; ++k) b[k] = bias[t.slot * N + k];
  Pack<T>* vy = reinterpret_cast<Pack<T>*>(y) + t.slot;
  Pack<T> p[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t px = t.p0 + static_cast<int64_t>(u) * t.ppb;
    if (px < pixels) p[u] = vy[px * slots];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t px = t.p0 + static_cast<int64_t>(u) * t.ppb;
    if (px >= pixels) continue;
#pragma unroll
    for (int k = 0; k < N; ++k) p[u].v[k] = relu(add(p[u].v[k], b[k]));
    vy[px * slots] = p[u];
  }
}

// blockIdx.x: a pooled row (b * H/2 + i); blockIdx.y: a run of ppb pooled
// columns; thread t moves channel vector t % slots of the quad under pooled
// column j = blockIdx.y * ppb + t / slots.
template <typename T>
__global__ void __launch_bounds__(kMaxSlots)
    bias_relu_pool_kernel(T* __restrict__ y, const T* __restrict__ bias, T* __restrict__ pooled,
                          int width, int slots) {
  constexpr int N = Lanes<T>::n;
  const int half = width / 2;
  const int slot = threadIdx.x % slots;
  const int j = blockIdx.y * (blockDim.x / slots) + threadIdx.x / slots;
  if (j >= half) return;
  const int64_t row = blockIdx.x;
  T b[N];
#pragma unroll
  for (int k = 0; k < N; ++k) b[k] = bias[slot * N + k];
  // the quad's top-left vector; the one below it lies a row (width pixels) on
  Pack<T>* q = reinterpret_cast<Pack<T>*>(y) + (2 * row * width + 2 * j) * slots + slot;
  const int64_t down = static_cast<int64_t>(width) * slots;
  Pack<T> p[4] = {q[0], q[slots], q[down], q[down + slots]};
  Pack<T> m;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float acc = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      p[s].v[k] = relu(add(p[s].v[k], b[k]));
      const float f = to_f(p[s].v[k]);
      if (f > acc || isnan(f)) acc = f;
    }
    m.v[k] = from_f<T>(acc);
  }
  q[0] = p[0];
  q[slots] = p[1];
  q[down] = p[2];
  q[down + slots] = p[3];
  reinterpret_cast<Pack<T>*>(pooled)[(row * half + j) * slots + slot] = m;
}

template <typename T>
__global__ void __launch_bounds__(kMaxSlots)
    cat_affine_relu_kernel(const T* __restrict__ skip, const T* __restrict__ up,
                           const T* __restrict__ up_bias, const T* __restrict__ scale,
                           const T* __restrict__ shift, T* __restrict__ out, int64_t pixels,
                           int skip_slots, int up_slots) {
  constexpr int N = Lanes<T>::n;
  const int slots = skip_slots + up_slots;
  const Tiling t = tiling(slots);
  const bool from_up = t.slot >= skip_slots;
  // the source's own channel vector and its vectors a pixel
  const int src_slot = from_up ? t.slot - skip_slots : t.slot;
  const int src_slots = from_up ? up_slots : skip_slots;
  const Pack<T>* src = reinterpret_cast<const Pack<T>*>(from_up ? up : skip) + src_slot;
  T s[N], sh[N], ub[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    s[k] = scale[t.slot * N + k];
    sh[k] = shift[t.slot * N + k];
    ub[k] = from_up ? up_bias[src_slot * N + k] : from_f<T>(0.0f);
  }
  Pack<T>* vo = reinterpret_cast<Pack<T>*>(out) + t.slot;
  Pack<T> p[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t px = t.p0 + static_cast<int64_t>(u) * t.ppb;
    if (px < pixels) p[u] = src[px * src_slots];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t px = t.p0 + static_cast<int64_t>(u) * t.ppb;
    if (px >= pixels) continue;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T v = from_up ? add(p[u].v[k], ub[k]) : p[u].v[k];
      p[u].v[k] = relu(add(mul(v, s[k]), sh[k]));
    }
    vo[px * slots] = p[u];
  }
}

// (threads, blocks) for ``slots`` channel vectors a pixel, or threads 0
// where a block cannot hold one pixel's vectors or the grid is too large
dim3 launch_shape(int64_t pixels, int slots, int* threads) {
  *threads = 0;
  if (slots <= 0 || slots > kMaxSlots) return dim3(0);
  const int per_block = slots >= kThreads ? 1 : kThreads / slots;  // pixels a block row
  const int64_t blocks = (pixels + static_cast<int64_t>(per_block) * kUnroll - 1) /
                         (static_cast<int64_t>(per_block) * kUnroll);
  if (blocks > INT32_MAX) return dim3(0);
  *threads = per_block * slots;
  return dim3(static_cast<unsigned>(blocks));
}

template <typename T>
int bias_relu(void* y, const void* bias, int64_t pixels, int channels, void* stream) {
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  int threads;
  const dim3 grid = launch_shape(pixels, channels / Lanes<T>::n, &threads);
  if (threads == 0 || channels % 8) return static_cast<int>(cudaErrorInvalidValue);
  bias_relu_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(y), static_cast<const T*>(bias), pixels, channels / Lanes<T>::n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bias_relu_pool(void* y, const void* bias, void* pooled, int64_t rows, int width,
                   int channels, void* stream) {
  if (rows == 0 || width == 0) return static_cast<int>(cudaSuccess);
  const int slots = channels / Lanes<T>::n;
  if (channels % 8 || width % 2 || slots <= 0 || slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ppb = slots >= kThreads ? 1 : kThreads / slots;  // pooled pixels a block row
  const int64_t col_blocks = (width / 2 + ppb - 1) / ppb;
  if (rows > INT32_MAX || col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(col_blocks));
  bias_relu_pool_kernel<T><<<grid, ppb * slots, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(y), static_cast<const T*>(bias), static_cast<T*>(pooled), width, slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cat_affine_relu(const void* skip, const void* up, const void* up_bias, const void* scale,
                    const void* shift, void* out, int64_t pixels, int c_skip, int c_up,
                    void* stream) {
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  constexpr int N = Lanes<T>::n;
  int threads;
  const dim3 grid = launch_shape(pixels, (c_skip + c_up) / N, &threads);
  if (threads == 0 || c_skip % 8 || c_up % 8 || c_skip <= 0 || c_up <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cat_affine_relu_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(skip), static_cast<const T*>(up), static_cast<const T*>(up_bias),
      static_cast<const T*>(scale), static_cast<const T*>(shift), static_cast<T*>(out), pixels,
      c_skip / N, c_up / N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer is a contiguous
// device array: activations channels-last and 16-byte aligned, the
// per-channel vectors of the same type. ``pixels`` is B * H * W; ``rows``
// is B * H / 2, the pooled rows, and ``width`` W, which is even. Each
// launches on ``stream`` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take), so the caller sees
// a refused launch.
extern "C" int bias_relu_bf16(void* y, const void* bias, int64_t pixels, int channels,
                              void* stream) {
  return bias_relu<__nv_bfloat16>(y, bias, pixels, channels, stream);
}

extern "C" int bias_relu_f32(void* y, const void* bias, int64_t pixels, int channels,
                             void* stream) {
  return bias_relu<float>(y, bias, pixels, channels, stream);
}

extern "C" int bias_relu_pool_bf16(void* y, const void* bias, void* pooled, int64_t rows,
                                   int width, int channels, void* stream) {
  return bias_relu_pool<__nv_bfloat16>(y, bias, pooled, rows, width, channels, stream);
}

extern "C" int bias_relu_pool_f32(void* y, const void* bias, void* pooled, int64_t rows,
                                  int width, int channels, void* stream) {
  return bias_relu_pool<float>(y, bias, pooled, rows, width, channels, stream);
}

extern "C" int cat_affine_relu_bf16(const void* skip, const void* up, const void* up_bias,
                                    const void* scale, const void* shift, void* out,
                                    int64_t pixels, int c_skip, int c_up, void* stream) {
  return cat_affine_relu<__nv_bfloat16>(skip, up, up_bias, scale, shift, out, pixels, c_skip,
                                        c_up, stream);
}

extern "C" int cat_affine_relu_f32(const void* skip, const void* up, const void* up_bias,
                                   const void* scale, const void* shift, void* out,
                                   int64_t pixels, int c_skip, int c_up, void* stream) {
  return cat_affine_relu<float>(skip, up, up_bias, scale, shift, out, pixels, c_skip, c_up,
                                stream);
}
