// hann_stitch: blend hann-weighted chips on a stride-k grid into the
// normalized canvas.
//
// Replaces the TPU kernel satellite_computervision_tpu/pallas/stitch.py::
// hann_stitch (pl.pallas_call at :130, body _stitch_kernel :68-80).
//
// What it computes. ``weighted`` is (rows*cols, side, side, C) float32,
// chip (r, c) placed at canvas (r*k, c*k), side <= 2k. The canvas is
// ((rows+1)*k, (cols+1)*k, C). Canvas block (R, C) of size (k, k) is the
// sum over a, b in {0, 1} of quadrant (a, b) of chip (R-a, C-b), chips off
// the grid and quadrant pixels past ``side`` contributing nothing. The sum
// is then multiplied by 1 / max(wy[y] * wx[x], 1e-8), where wy and wx are
// the separable 1-D hann weight sums (hann_inverse_weights in the JAX
// package builds the same product as a canvas-sized array).
//
// What bounds it. It is memory-bound: per output element it does at most
// four adds and three multiplies/divides. At the serving shape (16 chips of
// 640^2 x 1 -> a 2560^2 x 1 canvas) it reads ~26 MB and writes ~26 MB,
// i.e. ~16 us at the H100's 3.35 TB/s (to be confirmed on the card; see
// PERF.md and chip_smoke.py).
//
// What the design does about it. It is a gather with no atomics: one
// thread per output element (y, x, ch), channels innermost, so neighbouring
// threads read neighbouring chip addresses and write neighbouring canvas
// addresses. Every chip pixel that lands on the canvas is read once and
// every canvas pixel written once; the normalizer comes from two small 1-D
// arrays instead of a canvas-sized read. The four quadrant terms are added
// in the Pallas kernel's order (00, 01, 10, 11) so results match the plain
// PyTorch version bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void hann_stitch_kernel(const float* __restrict__ weighted,
                                   const float* __restrict__ wy,
                                   const float* __restrict__ wx,
                                   float* __restrict__ out, int rows, int cols,
                                   int k, int side, int channels,
                                   int canvas_w, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % channels);
  const int64_t pix = idx / channels;
  const int x = static_cast<int>(pix % canvas_w);
  const int y = static_cast<int>(pix / canvas_w);
  const int R = y / k, iy = y - R * k;
  const int C = x / k, ix = x - C * k;

  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = R - a, c = C - b;
      const int sy = a * k + iy, sx = b * k + ix;
      if (r >= 0 && r < rows && c >= 0 && c < cols && sy < side && sx < side) {
        const int64_t chip = static_cast<int64_t>(r) * cols + c;
        acc += weighted[((chip * side + sy) * side + sx) * channels + ch];
      }
    }
  }
  out[idx] = acc * (1.0f / fmaxf(wy[y] * wx[x], 1e-8f));
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on ``stream`` and
// returns cudaGetLastError() so the caller sees a refused launch.
extern "C" int hann_stitch_f32(const float* weighted, const float* wy,
                               const float* wx, float* out, int rows, int cols,
                               int kernel, int side, int channels,
                               void* stream) {
  const int canvas_w = (cols + 1) * kernel;
  const int64_t total =
      static_cast<int64_t>((rows + 1) * kernel) * canvas_w * channels;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  hann_stitch_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      weighted, wy, wx, out, rows, cols, kernel, side, channels, canvas_w,
      total);
  return static_cast<int>(cudaGetLastError());
}
