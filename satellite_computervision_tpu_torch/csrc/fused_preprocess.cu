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
// 117.4 MB and write 117.4 MB: 0.070 ms at the H100's 3.35 TB/s.
//
// What the design does about it. One launch, one read of the input from
// device memory, coalesced stores under every flip/rot90.
//   - One thread-block cluster of 8 CTAs per chip (grid (8, B)). CTA r owns
//     rows [r*ceil(K/8), (r+1)*ceil(K/8)) of its chip (none at small K; it
//     still meets the cluster barriers).
//   - Phase A: each CTA reduces the RAW values of its rows to a
//     per-channel (sum, min, max). The recolor is affine per channel and
//     float rounding is monotone, so the min over v of
//     fl((v-mean)*ct + mean*br) is the recolor of min(v) for ct >= 0, and of
//     max(v) for ct < 0: one read gives the mean and both recolored extrema.
//     Min and max propagate NaN (and a NaN that an infinity makes in the
//     recolor, which can only arise at an extreme of v).
//   - The partials go to shared memory; after cluster.sync() every CTA reads
//     all of them through distributed shared memory (map_shared_rank) and
//     folds them in rank order, so the CTAs of a chip hold bit-identical
//     statistics. A second cluster.sync() keeps each CTA's partials alive
//     until its peers have read them. No scratch buffer in device memory, no
//     second launch.
//   - Resident mode (where the input is 16-byte aligned with K*C % 4 == 0
//     and a CTA's rows fit in shared memory, as at the training shape: 32
//     rows x 7 KB with 8 CTAs per chip): one thread
//     issues a bulk copy (cp.async.bulk, completion on an mbarrier) per row,
//     in four chunks that phase A reduces as they land (1024 threads; warps
//     split the color channels and rows). Phase B reads the rows from shared
//     memory and stores their image under the morph: each thread keeps one
//     (output pixel, channel) slot of the image box and walks its rows by
//     fixed strides, so a warp stores consecutive floats whatever the
//     rotation and the loop does no division. Rows are padded by 16 bytes so
//     a rotated read's pixels do not share a shared-memory bank.
//   - Streamed mode (every other shape, e.g. the parking preset's 512^2 x 4
//     chips): phase A reads the rows with 16-byte loads where they are
//     16-byte aligned; phase B reads them again (from L2 where they still
//     are) in 32x32-pixel tiles staged in shared memory, 8 channels at a
//     time, and stores each tile's image.
//   - What holds it at ~57% of the bound: a CTA's load, barriers and stores
//     run in sequence, and with one 8-CTA cluster per chip on 132 SMs the
//     64 chips of a training batch run in waves (PERF.md).
// Every float operation of the recolor and rescale is rounded on its own
// (__fsub_rn, __fmul_rn, ...; no FMA contraction, IEEE division), as the
// plain version computes it; min and max are exact, only the mean is
// summed in another order than the plain version.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per chip
constexpr int kTile = 32;    // tile side in pixels
constexpr int kChunk = 8;    // channels staged per pass over the tiles
constexpr int kChunks = 4;   // bulk-copy chunks (one mbarrier each) of resident rows
constexpr int kMaxSmem = 232448;     // a block's shared memory on the H100

struct Params {
  int k, channels, n_color, augment, param_stride, rows_per_cta;
  int row_stride;    // floats between resident rows in shared memory
  int group_floats;  // resident phase A's per-group partials (even: 8-byte aligned after)
};

// min / max that propagate NaN, as torch.amin and jnp.min do (fminf and
// fmaxf drop it): a chip plane holding a NaN rescales to NaN everywhere.
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// (v - mean) * ct + mean*br, each operation rounded on its own.
__device__ __forceinline__ float recolor(float v, float mean, float ct, float mb) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, mean), ct), mb);
}

// Output pixel (oy, ox) of a K x K chip -> the input pixel it comes from.
__device__ __forceinline__ void unmorph(int oy, int ox, int k, int fv, int fh, int rot,
                                        int* y, int* x) {
  int y1, x1;
  switch (rot) {
    case 0: y1 = oy; x1 = ox; break;
    case 1: y1 = ox; x1 = k - 1 - oy; break;
    case 2: y1 = k - 1 - oy; x1 = k - 1 - ox; break;
    default: y1 = k - 1 - ox; x1 = oy; break;
  }
  *y = fv ? k - 1 - y1 : y1;
  *x = fh ? k - 1 - x1 : x1;
}

// Input pixel (y, x) -> where the morph puts it.
__device__ __forceinline__ void morph_to(int y, int x, int k, int fv, int fh, int rot,
                                         int* oy, int* ox) {
  const int y1 = fv ? k - 1 - y : y, x1 = fh ? k - 1 - x : x;
  switch (rot) {
    case 0: *oy = y1; *ox = x1; break;
    case 1: *oy = k - 1 - x1; *ox = y1; break;
    case 2: *oy = k - 1 - y1; *ox = k - 1 - x1; break;
    default: *oy = x1; *ox = k - 1 - y1; break;
  }
}

// Per-channel constants of phase B for one channel, from shared memory.
struct Channel {
  float mean, ct, mb, lo, denom;
  bool color;
};

__device__ __forceinline__ Channel channel_of(const float* prm, int c, int C, int n_color) {
  Channel ch;
  ch.color = c < n_color;
  ch.mean = prm[c];
  ch.ct = prm[C + c];
  ch.mb = prm[2 * C + c];
  ch.lo = prm[3 * C + c];
  ch.denom = prm[4 * C + c];
  return ch;
}

__device__ __forceinline__ float transform(float v, const Channel& ch, int augment) {
  if (!ch.color) return v;
  if (augment) v = recolor(v, ch.mean, ch.ct, ch.mb);
  return __fdiv_rn(__fsub_rn(v, ch.lo), ch.denom);
}

// Phase B, load side: input rows [ty, ty+th) x pixels [tx, tx+tw) of
// channels [c0, c0+cc), transformed, into tile[r * stride + px * cc + ch].
// Thread ``slot`` of a tile row takes LV consecutive floats; the lanes'
// channels ``chs`` are fixed for the whole pass.
template <int LV>
__device__ __forceinline__ void load_tile(const float* __restrict__ in, float* tile,
                                          const Channel* chs, int augment, int k,
                                          int C, int c0, int cc, int stride, int ty, int tx,
                                          int th, int tw, int slot, int r0, int rs) {
  if (slot * LV >= tw * cc) return;
  for (int r = r0; r < th; r += rs) {
    const float* src = in + ((ty + r) * k + tx) * C + c0;
    float* row = tile + r * stride;
    if (LV == 4) {  // cc == C: the row is one contiguous, aligned run
      const float4 v = __ldcs(reinterpret_cast<const float4*>(src) + slot);
      row[4 * slot] = transform(v.x, chs[0], augment);
      row[4 * slot + 1] = transform(v.y, chs[1], augment);
      row[4 * slot + 2] = transform(v.z, chs[2], augment);
      row[4 * slot + 3] = transform(v.w, chs[3], augment);
    } else {
      const int px = slot / cc, ch = slot - px * cc;
      row[slot] = transform(__ldcs(src + px * C + ch), chs[0], augment);
    }
  }
}

// The bulk copies that fill the resident slice, tracked by mbarriers.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {  // phase 0
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Streamed: phase B re-reads the rows from global memory (scalar or 16-byte
// loads). Resident: the rows stay in shared memory between the phases.
enum Mode { kStreamed1 = 0, kStreamed4 = 1, kResident = 2 };

template <int MODE>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(1024)
fused_preprocess_kernel(const float* __restrict__ bands, const float* __restrict__ contra,
                        const float* __restrict__ bright, const int* __restrict__ morph,
                        float* __restrict__ out, Params p) {
  constexpr int VEC = MODE == kStreamed1 ? 1 : 4;
  extern __shared__ __align__(128) float smem[];  // bulk copies and mbarriers need 16 / 8
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.channels, K = p.k, tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const int y0 = min(rank * p.rows_per_cta, K), y1 = min(y0 + p.rows_per_cta, K);
  const int rows = y1 - y0;
  const int64_t chip = static_cast<int64_t>(b) * K * K * C;
  const float* in = bands + chip;
  float* dst = out + chip;

  // shared memory: streamed [part | prm | work], resident [rows | part | prm | groups | bars]
  float* part;  // [3][C] this CTA's raw sum, min, max (read by its peers)
  float* work;  // streamed: phase A's reduction, then phase B's tile;
                // resident: the CTA's rows, p.row_stride floats apart
  if constexpr (MODE == kResident) {
    work = smem;
    part = smem + p.rows_per_cta * p.row_stride;
  } else {
    part = smem;
    work = smem + 8 * C;
  }
  float* prm = part + 3 * C;  // [5][C] mean, contra, mean*bright, lo, denom

  if constexpr (MODE == kResident) {
    // ---- phase A: the rows arrive by bulk copies in up to kChunks chunks,
    // each on its own mbarrier, and are reduced as they land. The warps
    // form ``groups`` groups per color channel; group g of channel c takes
    // rows g, g + groups, ... (lanes read pixels 32 apart), then thread c
    // folds the groups in order.
    float* slice = work;
    float* grp = prm + 5 * C;  // [3][groups * n_color]
    uint64_t* bars = reinterpret_cast<uint64_t*>(grp + p.group_floats);
    const int crows = (rows + kChunks - 1) / kChunks;
    const int nch = crows ? (rows + crows - 1) / crows : 0;
    if (tid == 0) {
      for (int i = 0; i < nch; ++i) mbar_init(bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int i = 0; i < nch; ++i) {
        const int r0 = i * crows, r1 = min(r0 + crows, rows);
        mbar_expect_tx(bars + i, static_cast<uint32_t>((r1 - r0) * K * C * sizeof(float)));
        for (int r = r0; r < r1; ++r)
          bulk_load(slice + r * p.row_stride, in + (y0 + r) * K * C,
                    static_cast<uint32_t>(K * C * sizeof(float)), bars + i);
      }
    }
    __syncthreads();  // the barriers are initialised before anyone waits
    const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
    const int nc = p.n_color, groups = max(1, nwarps / max(nc, 1)), units = groups * nc;
    for (int u = warp; u < units; u += nwarps) {
      const int c = u % nc, g = u / nc;
      float ss = 0.0f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
      for (int r = g; r < rows; r += groups) {
        mbar_wait(bars + r / crows);
        const float* row = slice + r * p.row_stride + c;
#pragma unroll 4
        for (int px = lane; px < K; px += 32) {
          const float v = row[px * C];
          ss += v;
          lo = nan_min(lo, v);
          hi = nan_max(hi, v);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {  // every lane ends with the same values
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) {
        grp[u] = ss;
        grp[units + u] = lo;
        grp[2 * units + u] = hi;
      }
    }
    for (int i = 0; i < nch; ++i) mbar_wait(bars + i);  // phase B reads every row
    __syncthreads();
    if (tid < nc) {
      float ss = 0.0f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
      for (int g = 0; g < groups; ++g) {
        const int u = g * nc + tid;
        ss += grp[u];
        lo = nan_min(lo, grp[units + u]);
        hi = nan_max(hi, grp[2 * units + u]);
      }
      part[tid] = ss;
      part[C + tid] = lo;
      part[2 * C + tid] = hi;
    }
  } else {
    // ---- phase A: raw (sum, min, max) per channel over rows [y0, y1).
    // ``ta`` is a multiple of C, so the lanes of a thread meet the same
    // channels at every step: lane i of thread t holds channel (VEC*t+i) % C.
    const int ta = C * (nt / C);
    float s[VEC], mn[VEC], mx[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] = 0.0f;
      mn[i] = CUDART_INF_F;
      mx[i] = -CUDART_INF_F;
    }
    if (p.n_color > 0 && tid < ta) {
      const int n = rows * K * C;
      const float* slice = in + y0 * K * C;
      if constexpr (VEC == 4) {  // K*C % 4 == 0 and 16-byte aligned: n % 4 == 0
        const float4* s4 = reinterpret_cast<const float4*>(slice);
#pragma unroll 4
        for (int j = tid; j < n / 4; j += ta) {
          const float4 v = __ldg(s4 + j);
          const float lanes[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            s[i] += lanes[i];
            mn[i] = nan_min(mn[i], lanes[i]);
            mx[i] = nan_max(mx[i], lanes[i]);
          }
        }
      } else {
#pragma unroll 4
        for (int j = tid; j < n; j += ta) {
          const float v = __ldg(slice + j);
          s[0] += v;
          mn[0] = nan_min(mn[0], v);
          mx[0] = nan_max(mx[0], v);
        }
      }
    }
    const int entries = VEC * ta;  // one (sum, min, max) per lane
    if (tid < ta) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        work[VEC * tid + i] = s[i];
        work[entries + VEC * tid + i] = mn[i];
        work[2 * entries + VEC * tid + i] = mx[i];
      }
    }
    __syncthreads();
    // two fixed-order steps: thread (g, c) folds VEC entries of channel c,
    // then thread c folds the ta / C groups
    float* red = work + 3 * entries;
    if (tid < ta) {
      const int c = tid % C, g = tid / C;
      float ss = 0.0f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int e = c + C * (g * VEC + i);
        ss += work[e];
        lo = nan_min(lo, work[entries + e]);
        hi = nan_max(hi, work[2 * entries + e]);
      }
      red[tid] = ss;
      red[ta + tid] = lo;
      red[2 * ta + tid] = hi;
    }
    __syncthreads();
    if (tid < C) {
      float ss = 0.0f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
      for (int g = 0; g < ta / C; ++g) {
        ss += red[g * C + tid];
        lo = nan_min(lo, red[ta + g * C + tid]);
        hi = nan_max(hi, red[2 * ta + g * C + tid]);
      }
      part[tid] = ss;
      part[C + tid] = lo;
      part[2 * C + tid] = hi;
    }
  }
  cluster.sync();

  // ---- the chip's statistics: every CTA's partials through distributed
  // shared memory, in rank order (bit-identical in every CTA of the
  // cluster). Warp w takes channels w, w + nwarps, ...; lane r reads rank
  // r (all ranks at once), then every lane folds them in rank order.
  for (int c = tid / 32; c < p.n_color; c += nt / 32) {
    const int lane = tid % 32;
    float ps = 0.0f, pmin = CUDART_INF_F, pmax = -CUDART_INF_F;
    if (lane < kCluster) {
      const float* peer = cluster.map_shared_rank(part, lane);
      ps = peer[c];
      pmin = peer[C + c];
      pmax = peer[2 * C + c];
    }
    float ss = 0.0f, vmin = CUDART_INF_F, vmax = -CUDART_INF_F;
    for (int r = 0; r < kCluster; ++r) {
      ss += __shfl_sync(0xffffffffu, ps, r);
      vmin = nan_min(vmin, __shfl_sync(0xffffffffu, pmin, r));
      vmax = nan_max(vmax, __shfl_sync(0xffffffffu, pmax, r));
    }
    if (lane != 0) continue;
    float mean = 0.0f, ct = 1.0f, mb = 0.0f, lo = vmin, hi = vmax;
    if (p.augment) {
      mean = __fdiv_rn(ss, static_cast<float>(K * K));
      ct = contra[b * p.param_stride + c];
      mb = __fmul_rn(mean, bright[b * p.param_stride + c]);
      // the recolor is monotone in v: increasing for ct >= 0, decreasing
      // for ct < 0 (constant for ct == 0: both give mean*bright)
      const float at_min = recolor(vmin, mean, ct, mb), at_max = recolor(vmax, mean, ct, mb);
      lo = ct < 0.0f ? at_max : at_min;
      hi = ct < 0.0f ? at_min : at_max;
      // an infinity makes a recolored value NaN (inf - inf, inf * 0) only at
      // an extreme of v; the plane then holds a NaN, so both extrema are NaN
      if (at_min != at_min || at_max != at_max) lo = hi = CUDART_NAN_F;
    }
    prm[c] = mean;
    prm[C + c] = ct;
    prm[2 * C + c] = mb;
    prm[3 * C + c] = lo;
    prm[4 * C + c] = __fadd_rn(__fsub_rn(hi, lo), 1e-8f);
  }
  cluster.sync();  // peers are done with ``part``; ``prm`` is visible block-wide

  // ---- phase B: the rows' image under the morph
  int fv = 0, fh = 0, rot = 0;
  if (p.augment) {
    fv = morph[3 * b];
    fh = morph[3 * b + 1];
    rot = ((morph[3 * b + 2] % 4) + 4) % 4;
  }
  // the inverse morph is affine: input = g0 + d/d(oy) * oy + d/d(ox) * ox
  int gy0, gx0, gy_r, gx_r, gy_c, gx_c;
  unmorph(0, 0, K, fv, fh, rot, &gy0, &gx0);
  unmorph(1, 0, K, fv, fh, rot, &gy_r, &gx_r);
  unmorph(0, 1, K, fv, fh, rot, &gy_c, &gx_c);
  gy_r -= gy0; gx_r -= gx0; gy_c -= gy0; gx_c -= gx0;
  const bool odd = rot & 1;

  if constexpr (MODE == kResident) {
    // transform on the way out. A unit is one float of an output row of the
    // image box (pixel po, channel ch) and a row group; its thread walks
    // rows ro = r0, r0 + rs, ... by adding fixed strides, so the loop's
    // iterations are independent and a warp stores consecutive floats.
    if (rows == 0) return;
    int ay, ax, by, bx;
    morph_to(y0, 0, K, fv, fh, rot, &ay, &ax);
    morph_to(y1 - 1, K - 1, K, fv, fh, rot, &by, &bx);
    const int oy0 = min(ay, by), ox0 = min(ax, bx);
    const int oh = odd ? K : rows, ow = odd ? rows : K;
    const int S = p.row_stride;
    const float* slice = work;
    const int base = (gy0 + gy_r * oy0 + gy_c * ox0 - y0) * S + (gx0 + gx_r * oy0 + gx_c * ox0) * C;
    const int d_row = gy_r * S + gx_r * C, d_px = gy_c * S + gx_c * C;
    const int slots = ow * C, rs = max(1, nt / slots);
    for (int u = tid; u < slots * rs; u += nt) {
      const int sl = u % slots, r0 = u / slots;
      const int po = sl / C, ch = sl - po * C;
      const Channel chv = channel_of(prm, ch, C, p.n_color);
      int src = base + r0 * d_row + po * d_px + ch;
      float* o = dst + ((oy0 + r0) * K + ox0 + po) * C + ch;
#pragma unroll 4
      for (int ro = r0; ro < oh; ro += rs) {
        __stcs(o, transform(slice[src], chv, p.augment));
        src += rs * d_row;
        o += rs * K * C;
      }
    }
  } else {
    // tiles of rows [y0, y1), transformed into shared memory, then stored
    // as their image under the morph
    const bool whole = VEC == 4 && C <= kChunk;  // the tile row is one aligned run
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int cc = min(kChunk, C - c0);
      const int stride = (kTile + 1) * cc;  // floats per tile row, one pixel of padding
      // load side: LV floats per thread, V threads per tile row
      const int lv = whole ? 4 : 1;
      const int lslots = kTile * cc / lv, lslot = tid % lslots;
      const int lr0 = tid / lslots, lrs = nt / lslots;
      Channel chs[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (lslot * lv + i) % cc;  // lanes past lv are unused
        chs[i] = channel_of(prm, c0 + c, C, p.n_color);
      }
      // store side: one float per thread, one output tile row per kTile*cc threads
      const int sslots = kTile * cc, sslot = tid % sslots;
      const int spx = sslot / cc, sch = sslot - spx * cc;
      const int sr0 = tid / sslots, srs = nt / sslots;

      for (int ty = y0; ty < y1; ty += kTile) {
        const int th = min(kTile, y1 - ty);
        for (int tx = 0; tx < K; tx += kTile) {
          const int tw = min(kTile, K - tx);
          if (lr0 < lrs) {
            if (whole)
              load_tile<4>(in, work, chs, p.augment, K, C, c0, cc, stride, ty, tx, th, tw,
                           lslot, lr0, lrs);
            else
              load_tile<1>(in, work, chs, p.augment, K, C, c0, cc, stride, ty, tx, th, tw,
                           lslot, lr0, lrs);
          }
          __syncthreads();
          // the tile's image: an (oh, ow) box at (oy0, ox0)
          int ay, ax, by, bx;
          morph_to(ty, tx, K, fv, fh, rot, &ay, &ax);
          morph_to(ty + th - 1, tx + tw - 1, K, fv, fh, rot, &by, &bx);
          const int oy0 = min(ay, by), ox0 = min(ax, bx);
          const int oh = odd ? tw : th, ow = odd ? th : tw;
          // shared-memory index of output (oy0 + ro, ox0 + po), channel ch
          const int base = (gy0 + gy_r * oy0 + gy_c * ox0 - ty) * stride +
                           (gx0 + gx_r * oy0 + gx_c * ox0 - tx) * cc;
          const int d_row = gy_r * stride + gx_r * cc, d_px = gy_c * stride + gx_c * cc;
          if (sr0 < srs && spx < ow) {
            const int col = base + spx * d_px + sch;
            float* orow = dst + (oy0 * K + ox0 + spx) * C + c0 + sch;
            for (int ro = sr0; ro < oh; ro += srs)
              __stcs(orow + ro * K * C, work[col + ro * d_row]);
          }
          __syncthreads();
        }
      }
    }
  }
}

template <int MODE>
cudaError_t launch(int batch, int threads, int smem, cudaStream_t s, const float* bands,
                   const float* contra, const float* bright, const int* morph, float* out,
                   const Params& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_preprocess_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_preprocess_kernel<MODE><<<dim3(kCluster, batch), threads, smem, s>>>(
      bands, contra, bright, morph, out, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``contra``/``bright`` are
// (B, param_stride) float32 and ``morph`` (B, 3) int32; all three may be
// null when augment == 0. Each CTA's rows stay in shared memory between the
// phases where they fit (and the input is 16-byte aligned); otherwise phase
// B re-reads them from global memory. One launch on ``stream``; returns its
// cudaError so the caller sees a refused launch.
extern "C" int fused_preprocess_f32(const float* bands, const float* contra,
                                    const float* bright, const int* morph, float* out,
                                    int batch, int k, int channels, int n_color,
                                    int augment, int param_stride,
                                    void* stream) {
  if (batch == 0 || k == 0 || channels == 0) return static_cast<int>(cudaSuccess);
  if (channels > 1024 || batch > 65535 ||
      static_cast<int64_t>(k) * k * channels > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.k = k;
  p.channels = channels;
  p.n_color = n_color;
  p.augment = augment;
  p.param_stride = param_stride;
  p.rows_per_cta = (k + kCluster - 1) / kCluster;
  const int row = k * channels;  // floats per chip row
  const bool vec = row % 4 == 0 && reinterpret_cast<uintptr_t>(bands) % 16 == 0;
  // a row stride of 32*m floats would put a rotated read's pixels on one
  // shared-memory bank: pad it by 16 bytes
  p.row_stride = row % 32 == 0 ? row + 4 : row;
  p.group_floats = (3 * (n_color > 32 ? n_color : 32) + 1) / 2 * 2;
  const int64_t resident_bytes =
      sizeof(float) * (static_cast<int64_t>(p.rows_per_cta) * p.row_stride + 8 * channels +
                       p.group_floats) +
      sizeof(uint64_t) * kChunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && resident_bytes <= kMaxSmem)  // one CTA of 32 warps per SM
    return static_cast<int>(launch<kResident>(batch, 1024, static_cast<int>(resident_bytes), s,
                                              bands, contra, bright, morph, out, p));
  // 512 threads keep enough loads in flight with one CTA per SM (the
  // parking preset's 512^2 x 4 chips: PERF.md); phase A needs >= C threads
  const int threads = channels <= 512 ? 512 : (channels + 31) / 32 * 32;
  const int lanes = vec ? 4 : 1;
  const int ta = channels * (threads / channels);
  const int cc = channels < kChunk ? channels : kChunk;
  const int phase_a = 3 * lanes * ta + 3 * ta, tile = kTile * (kTile + 1) * cc;
  const int smem = static_cast<int>(sizeof(float)) *
                   (8 * channels + (phase_a > tile ? phase_a : tile));
  const cudaError_t err =
      vec ? launch<kStreamed4>(batch, threads, smem, s, bands, contra, bright, morph, out, p)
          : launch<kStreamed1>(batch, threads, smem, s, bands, contra, bright, morph, out, p);
  return static_cast<int>(err);
}
