// hann_stitch: blend chips on a stride-k grid into the hann-normalized
// canvas, optionally applying the hann window to each chip on the way.
//
// Replaces the TPU kernel satellite_computervision_tpu/pallas/stitch.py::
// hann_stitch (pl.pallas_call at :130, body _stitch_kernel :68-80), and the
// window multiply that the JAX engine runs before it
// (satellite_computervision_tpu/inference/tiles.py:366-367).
//
// What it computes. ``chips`` is (rows*cols, side, side, C) float32, chip
// (r, c) placed at canvas (r*k, c*k), side <= 2k. The canvas is
// ((rows+1)*k, (cols+1)*k, C). Canvas block (R, Cb) of size (k, k) is the
// sum over a, b in {0, 1} of quadrant (a, b) of chip (R-a, Cb-b), chips off
// the grid and quadrant pixels past ``side`` contributing nothing. With
// ``apply_window`` each chip pixel (sy, sx) is first multiplied by
// fl(w1[sy] * w1[sx]), w1 = hann_window_1d(side) (the engine's route: raw
// predictions in); without it the chips arrive hann-weighted (the TPU
// kernel's function). The sum is then multiplied by
// 1 / max(wy[y] * wx[x], 1e-8), wy and wx being the separable 1-D hann
// weight sums.
//
// What bounds it. It is memory-bound. At the serving shape (16 chips of
// 640^2 x 1 -> a 2560^2 x 1 canvas) the engine's route reads the 26.2 MB of
// predictions, w1, wy and wx once and writes the 26.2 MB canvas: 0.0157 ms
// at the H100's 3.35 TB/s.
//
// What the design does about it. A 2-D grid: block (Cb, g) owns canvas
// column block Cb (k pixels, k*C contiguous floats of every row) for a
// group of rows. Per row it works out once the canvas row's block row R,
// the two chip rows that reach it and their weights; threads then walk the
// column block four floats at a time with 16-byte loads and stores (where
// k*C and side*C are multiples of 4 and the pointers 16-byte aligned, as at
// the serving shape; elsewhere one float at a time with the same
// arithmetic). No 64-bit division, no atomics: every chip float that lands
// on the canvas is read once, every canvas float written once, and the
// window and the normalizer come from small 1-D arrays. The products and
// sums are rounded op by op (__fmul_rn, __fadd_rn: no FMA contraction) and
// the quadrants are added in the Pallas kernel's order (00, 01, 10, 11), so
// the result is bit-equal to the plain PyTorch version on both routes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// canvas rows per block (in one column block): 2 was the fastest of 1, 2
// and 4 at the serving shape (PERF.md)
constexpr int kRowsPerBlock = 2;

struct Geometry {
  int rows, cols, k, side, channels, canvas_h, apply_window;
};

// VEC consecutive floats of a small 1-D array (16-byte aligned where VEC == 4)
template <int VEC>
__device__ __forceinline__ void load_run(const float* __restrict__ a, int i, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(a + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(a + i);
  }
}

template <int VEC>
__global__ void hann_stitch_kernel(const float* __restrict__ chips,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ wy,
                                   const float* __restrict__ wx,
                                   float* __restrict__ out, Geometry g) {
  const int C = g.channels, k = g.k;
  const int kc = k * C, sc = g.side * C;  // floats per column block / chip row
  const int cb = blockIdx.x;
  const int canvas_wc = (g.cols + 1) * kc;
  const int y_end = min((blockIdx.y + 1) * kRowsPerBlock, g.canvas_h);
  // one channel: a lane's pixel is its float, so w1 and wx come in runs too
  const bool runs = C == 1;
  for (int y = blockIdx.y * kRowsPerBlock; y < y_end; ++y) {
    const int R = y / k, iy = y - R * k;
    // quadrant (a, b): chip (R-a, cb-b), row a*k + iy, from float b*kc
    const float* src[2][2];
    float wrow[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = R - a, sy = a * k + iy;
      const bool row_ok = r >= 0 && r < g.rows && sy < g.side;
      wrow[a] = row_ok && g.apply_window ? w1[sy] : 0.0f;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int c = cb - b;
        src[a][b] = row_ok && c >= 0 && c < g.cols
                        ? chips + (static_cast<int64_t>(r * g.cols + c) * g.side + sy) * sc + b * kc
                        : nullptr;
      }
    }
    const float wyv = wy[y];
    float* orow = out + static_cast<int64_t>(y) * canvas_wc + cb * kc;
    for (int f = threadIdx.x * VEC; f < kc; f += blockDim.x * VEC) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          // quadrant b = 1 holds the chip's floats past kc
          if (src[a][b] == nullptr || f + b * kc >= sc) continue;
          float v[VEC];
          if (VEC == 4) {
            const float4 q = __ldcs(reinterpret_cast<const float4*>(src[a][b] + f));
            v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
          } else {
            v[0] = __ldcs(src[a][b] + f);
          }
          if (g.apply_window) {
            float w[VEC];
            if (runs) {
              load_run<VEC>(w1, b * k + f, w);
            } else {
#pragma unroll
              for (int i = 0; i < VEC; ++i) w[i] = __ldg(w1 + b * k + (f + i) / C);
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[i] = __fmul_rn(v[i], __fmul_rn(wrow[a], w[i]));
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
        }
      }
      float w[VEC], o[VEC];
      if (runs) {
        load_run<VEC>(wx, cb * k + f, w);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) w[i] = __ldg(wx + cb * k + (f + i) / C);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = __fmul_rn(acc[i], __fdiv_rn(1.0f, fmaxf(__fmul_rn(wyv, w[i]), 1e-8f)));
      if (VEC == 4)
        __stcs(reinterpret_cast<float4*>(orow + f), make_float4(o[0], o[1], o[2], o[3]));
      else
        __stcs(orow + f, o[0]);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``w1`` (side floats) is read
// only when apply_window != 0. Launches on ``stream`` and returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int hann_stitch_f32(const float* chips, const float* w1, const float* wy,
                               const float* wx, float* out, int rows, int cols,
                               int kernel, int side, int channels, int apply_window,
                               void* stream) {
  Geometry g;
  g.rows = rows;
  g.cols = cols;
  g.k = kernel;
  g.side = side;
  g.channels = channels;
  g.canvas_h = (rows + 1) * kernel;
  g.apply_window = apply_window;
  if (kernel == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (static_cast<int64_t>(cols + 1) * kernel * channels > INT32_MAX ||
      static_cast<int64_t>(side) * side * channels > INT32_MAX ||
      (g.canvas_h + kRowsPerBlock - 1) / kRowsPerBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = kernel * channels;
  const bool vec = kc % 4 == 0 && (side * channels) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(chips) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wx) % 16 == 0;
  const int lanes = vec ? 4 : 1;
  const int slots = (kc + lanes - 1) / lanes;
  const int threads = slots >= 256 ? 256 : (slots + 31) / 32 * 32;
  const dim3 grid(cols + 1, (g.canvas_h + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    hann_stitch_kernel<4><<<grid, threads, 0, s>>>(chips, w1, wy, wx, out, g);
  else
    hann_stitch_kernel<1><<<grid, threads, 0, s>>>(chips, w1, wy, wx, out, g);
  return static_cast<int>(cudaGetLastError());
}
