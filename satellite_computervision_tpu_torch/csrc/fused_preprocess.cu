// fused_preprocess: per-chip, per-channel recolor + min/max rescale of an
// NHWC chip stack, with the chip's flip/rot90 applied through the store
// index.
//
// Replaces the TPU kernel satellite_computervision_tpu/pallas/preprocess.py::
// fused_preprocess (pl.pallas_call at :135, body _recolor_rescale_kernel
// :35-57, wrapper :81-150; the flip/rot90 there runs after the kernel as
// XLA ops, :148-149).
//
// What it computes. ``bands`` is (B, K, K, C) float32, channels last, as
// the input pipeline stacks it. For chip b and channel c < n_color, with v
// the (K, K) plane:
//   if augment: mean = sum(v) / K^2;  v = (v - mean) * contra[b, c] + mean * bright[b, c]
//   v = (v - min(v)) / (max(v) - min(v) + 1e-8)
// Channels c >= n_color (one-hot features, labels) pass through. If
// augment, output pixel (y', x') of chip b takes the value of input pixel
// (y, x), where (y', x') is the image of (y, x) under flip-v (if
// morph[b, 0]), then flip-h (if morph[b, 1]), then rot90 morph[b, 2] times
// (numpy's rot90 over axes (0, 1): (a, b) -> (K-1-b, a)) — apply_morph's
// order.
//
// What bounds it. It is memory-bound: about ten float operations per
// element. At the training shape (B = 64, K = 256, C = 7) it must read
// 117.4 MB and write 117.4 MB, i.e. ~70 us at the H100's 3.35 TB/s.
//
// What the design does about it (a simple design that is right first;
// fusing the passes, keeping planes in shared memory and TMA are later
// work). The grid is (tiles, B): each chip is cut into ``tiles`` runs of
// whole pixels so that the 64 chips fill the 132 SMs. A block has
// T = C * floor(256 / C) threads (T = C for C > 256), so thread t always
// meets channel t % C while it walks its run in steps of T: reads are
// contiguous across the block and every thread reduces one channel. Three
// passes:
//   1. per-(chip, tile, channel) partial sums (only when augmenting);
//   2. partial min and max of the recolored values (recomputed, not
//      stored), the mean summed from pass 1's partials in a fixed order;
//   3. recolor, rescale and store through the morph index.
// Partials live in a (3, B, tiles, C) scratch buffer the wrapper
// allocates; every block that needs a chip's mean/min/max reduces its
// partials in the same order, so passes 2 and 3 agree exactly. Min and max
// are exact; the mean is summed in another order than the plain version,
// so results agree to a tolerance, not bit for bit. IEEE division (no
// fast math).

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

struct Geometry {
  int64_t pixels;      // K * K
  int64_t chunk;       // pixels per tile
  int k, channels, n_color, tiles, param_stride;
};

// The element range [start, stop) of (chip, tile) in the flat NHWC input.
__device__ __forceinline__ void tile_range(const Geometry& g, int b, int t,
                                           int64_t* start, int64_t* stop) {
  const int64_t p0 = static_cast<int64_t>(t) * g.chunk;
  const int64_t p1 = p0 + g.chunk < g.pixels ? p0 + g.chunk : g.pixels;
  const int64_t base = static_cast<int64_t>(b) * g.pixels * g.channels;
  *start = base + (p0 < g.pixels ? p0 : g.pixels) * g.channels;
  *stop = base + p1 * g.channels;
}

// Per-channel mean of chip b from pass 1's partials (fixed order).
__device__ __forceinline__ float chip_mean(const Geometry& g, const float* sums,
                                           int b, int c) {
  float s = 0.0f;
  for (int t = 0; t < g.tiles; ++t) s += sums[(static_cast<int64_t>(b) * g.tiles + t) * g.channels + c];
  return s / static_cast<float>(g.pixels);
}

// Reduce a block's per-thread values to one per channel: thread c < C
// combines smem[c], smem[c + C], ... in order.
__device__ __forceinline__ float reduce_column_sum(const float* smem, int c, int C, int T) {
  float s = 0.0f;
  for (int j = c; j < T; j += C) s += smem[j];
  return s;
}

// min / max that propagate NaN, as torch.amin and jnp.min do (fminf and
// fmaxf drop it): a chip plane holding a NaN rescales to NaN everywhere.
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float reduce_column_min(const float* smem, int c, int C, int T) {
  float s = smem[c];
  for (int j = c + C; j < T; j += C) s = nan_min(s, smem[j]);
  return s;
}

__device__ __forceinline__ float reduce_column_max(const float* smem, int c, int C, int T) {
  float s = smem[c];
  for (int j = c + C; j < T; j += C) s = nan_max(s, smem[j]);
  return s;
}

// Pass 1: partial sums per (chip, tile, channel).
__global__ void partial_sum_kernel(const float* __restrict__ bands,
                                   float* __restrict__ sums, Geometry g) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, T = blockDim.x;
  int64_t start, stop;
  tile_range(g, b, t, &start, &stop);
  float acc = 0.0f;
  for (int64_t e = start + tid; e < stop; e += T) acc += bands[e];
  smem[tid] = acc;
  __syncthreads();
  if (tid < g.channels)
    sums[(static_cast<int64_t>(b) * g.tiles + t) * g.channels + tid] =
        reduce_column_sum(smem, tid, g.channels, T);
}

// Pass 2: partial min / max of the recolored values.
__global__ void partial_minmax_kernel(const float* __restrict__ bands,
                                      const float* __restrict__ contra,
                                      const float* __restrict__ bright,
                                      const float* __restrict__ sums,
                                      float* __restrict__ mins,
                                      float* __restrict__ maxs, Geometry g,
                                      int augment) {
  extern __shared__ float smem[];  // T floats for the reduction + C means
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, T = blockDim.x;
  const int C = g.channels, c = tid % C;
  float* means = smem + T;
  if (augment && tid < C) means[tid] = chip_mean(g, sums, b, tid);
  __syncthreads();
  const bool color = c < g.n_color;
  float mean = 0.0f, ct = 1.0f, br = 1.0f;
  if (augment && color) {
    mean = means[c];
    ct = contra[static_cast<int64_t>(b) * g.param_stride + c];
    br = bright[static_cast<int64_t>(b) * g.param_stride + c];
  }
  int64_t start, stop;
  tile_range(g, b, t, &start, &stop);
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  if (color) {
    for (int64_t e = start + tid; e < stop; e += T) {
      float v = bands[e];
      if (augment) v = (v - mean) * ct + mean * br;
      lo = nan_min(lo, v);
      hi = nan_max(hi, v);
    }
  }
  const int64_t out = (static_cast<int64_t>(b) * g.tiles + t) * C;
  smem[tid] = lo;
  __syncthreads();
  if (tid < C) lo = reduce_column_min(smem, tid, C, T);
  __syncthreads();
  smem[tid] = hi;
  __syncthreads();
  if (tid < C) {
    mins[out + tid] = lo;
    maxs[out + tid] = reduce_column_max(smem, tid, C, T);
  }
}

// Pass 3: recolor, rescale, store through the morph index.
__global__ void apply_kernel(const float* __restrict__ bands,
                             const float* __restrict__ contra,
                             const float* __restrict__ bright,
                             const int* __restrict__ morph,
                             const float* __restrict__ sums,
                             const float* __restrict__ mins,
                             const float* __restrict__ maxs,
                             float* __restrict__ out, Geometry g, int augment) {
  extern __shared__ float smem[];  // mean, lo, hi per channel
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, T = blockDim.x;
  const int C = g.channels, c = tid % C, K = g.k;
  if (tid < C && tid < g.n_color) {
    const int64_t row = static_cast<int64_t>(b) * g.tiles * C;
    float lo = mins[row + tid], hi = maxs[row + tid];
    for (int i = 1; i < g.tiles; ++i) {
      lo = nan_min(lo, mins[row + static_cast<int64_t>(i) * C + tid]);
      hi = nan_max(hi, maxs[row + static_cast<int64_t>(i) * C + tid]);
    }
    smem[tid] = augment ? chip_mean(g, sums, b, tid) : 0.0f;
    smem[C + tid] = lo;
    smem[2 * C + tid] = hi;
  }
  __syncthreads();
  const bool color = c < g.n_color;
  float mean = 0.0f, ct = 1.0f, br = 1.0f, lo = 0.0f, denom = 1.0f;
  if (color) {
    lo = smem[C + c];
    denom = (smem[2 * C + c] - lo) + 1e-8f;
    if (augment) {
      mean = smem[c];
      ct = contra[static_cast<int64_t>(b) * g.param_stride + c];
      br = bright[static_cast<int64_t>(b) * g.param_stride + c];
    }
  }
  int fv = 0, fh = 0, rot = 0;
  if (augment) {
    fv = morph[3 * b];
    fh = morph[3 * b + 1];
    rot = ((morph[3 * b + 2] % 4) + 4) % 4;
  }
  const int64_t base = static_cast<int64_t>(b) * g.pixels * C;
  int64_t start, stop;
  tile_range(g, b, t, &start, &stop);
  for (int64_t e = start + tid; e < stop; e += T) {
    float v = bands[e];
    if (color) {
      if (augment) v = (v - mean) * ct + mean * br;
      v = (v - lo) / denom;
    }
    int64_t dst = e;
    if (augment) {
      const int64_t p = (e - base) / C;
      int y = static_cast<int>(p / K), x = static_cast<int>(p - static_cast<int64_t>(y) * K);
      if (fv) y = K - 1 - y;
      if (fh) x = K - 1 - x;
      for (int r = 0; r < rot; ++r) {  // (a, b) -> (K-1-b, a)
        const int ny = K - 1 - x;
        x = y;
        y = ny;
      }
      dst = base + (static_cast<int64_t>(y) * K + x) * C + c;
    }
    out[dst] = v;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``scratch`` holds 3 * B * tiles
// * C floats. ``contra``/``bright`` are (B, param_stride) float32 and
// ``morph`` (B, 3) int32; all three may be null when augment == 0. Launches
// on ``stream`` and returns cudaGetLastError() so the caller sees a refused
// launch.
extern "C" int fused_preprocess_f32(const float* bands, const float* contra,
                                    const float* bright, const int* morph,
                                    float* out, float* scratch, int batch,
                                    int k, int channels, int n_color,
                                    int augment, int tiles, int param_stride,
                                    void* stream) {
  if (batch == 0 || k == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (channels > 1024 || tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geometry g;
  g.pixels = static_cast<int64_t>(k) * k;
  g.chunk = (g.pixels + tiles - 1) / tiles;
  g.k = k;
  g.channels = channels;
  g.n_color = n_color;
  g.tiles = tiles;
  g.param_stride = param_stride;
  const int threads = channels <= 256 ? channels * (256 / channels) : channels;
  const dim3 grid(tiles, batch);
  float* sums = scratch;
  float* mins = scratch + static_cast<int64_t>(batch) * tiles * channels;
  float* maxs = mins + static_cast<int64_t>(batch) * tiles * channels;
  if (n_color > 0) {
    if (augment) {
      partial_sum_kernel<<<grid, threads, threads * sizeof(float), s>>>(bands, sums, g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    partial_minmax_kernel<<<grid, threads, (threads + channels) * sizeof(float), s>>>(
        bands, contra, bright, sums, mins, maxs, g, augment);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apply_kernel<<<grid, threads, 3 * channels * sizeof(float), s>>>(
      bands, contra, bright, morph, sums, mins, maxs, out, g, augment);
  return static_cast<int>(cudaGetLastError());
}
