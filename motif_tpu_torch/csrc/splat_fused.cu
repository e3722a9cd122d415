// splat_fused: forward softmax splat fused with the norm and count splats,
// and the ones-initialised max splat of e^z in the same pass.
//
// Replaces the TPU kernel motif_tpu/ops/softsplat_pallas.py::_splat_kernel
// (the ring-sweep MXU placement behind splat_fused_pallas) and, for the
// max, motif_tpu/ops/softsplat.py::_splat_max_scan. Same contract as
// motif_tpu/ops/softsplat.py::splat_fused: each source pixel p lands at
// q = p + flow(p) and bilinearly scatters [img * e^z | e^z] into q's four
// integer corners, plus an unweighted +1 per in-image corner (the count,
// which a corner of weight 0 gets too). Corners outside the image are
// dropped, as the reference CUDA kernel drops them (softsplat_cp.py:30-38).
//
// Two entries, by the type the sums are kept in. float32: everything in
// float32. float16 (motif_tpu's scatter_dtype=float16 of _splat_fused_base):
// the corner weights' factors, e^z and img * e^z are rounded to float16,
// the per-corner products and the running sums (norm and count included)
// are float16, the tile in shared memory holds halves, and the results are
// returned as float32; the max stays float32 on the unrounded weights. Each
// float16 operation is correctly rounded once: done in float32 on float16
// values and rounded (24 >= 2 * 11 + 2 bits), or as one half instruction
// (__hmul2_rn, __hadd2), which gives the same value.
//
// Layout (NHWC, float32, contiguous):
//   img  (B, H, W, C)   flow (B, H, W, 2) = (dx, dy)   ez (B, H, W)
//   acc  (B, H, W, C + 2): channels [0, C) the splatted img * e^z, C the
//        norm (splatted e^z), C + 1 the count. Written whole: no fill.
//   zmax (B, H, W): max(1, max over corners of e^z * w), or 1 everywhere
//        when the caller skips the max (z <= 0 makes it 1). Written whole.
//   work scratch: 4 * B * H * W record slots of 32 bytes (the tile lists;
//        a source is listed in at most 4 tiles), then n_tiles counters and
//        n_tiles + 1 list offsets (ints).
//
// Bound on an H100: memory. Each source pixel reads C + 3 floats and each
// target pixel is written once, C + 3 floats (C + 2 without the max):
// 0.22 ms at 3.35 TB/s for 6 x 256 x 448 x 130, 0.11 ms at C = 64. About 9
// flops per channel and source, ~1 flop per byte moved, far below the
// card's fp32 rate.
//
// Design: the TPU kernel accumulates each output row block on chip and
// writes it once (a VMEM ring of the target rows a source row can reach).
// A Hopper block has 227 KB of shared memory, less than one full-width row
// at C = 130, so the targets are cut into TH x TW tiles instead (the plan
// of ops/softsplat.py picks them per width and sum type), and the sources
// are binned by the tiles their corners reach, which puts no limit on the
// flow. A memset of the counters and four kernels on the caller's stream:
//   1. count: one thread per source pixel adds 1 to the counter of each
//      distinct tile (1, 2 or 4) that holds one of its in-image corners;
//      lanes of a warp that hit the same tile share one atomicAdd;
//   2. scan: one block turns the counters into list offsets, 1024
//      consecutive counters a round, all rounds' loads in flight at once;
//   3. fill: the same walk writes a record per (source, tile) into that
//      tile's list, the slot from an atomic cursor: integer atomics on
//      n_tiles ints;
//   4. accumulate: one block per tile zeroes a [TH * TW, C + 2] tile of
//      sums and a ones tile for the max in shared memory, walks its list
//      and writes the tile's in-image pixels to acc and zmax, once. Every
//      word of the tile has one owning thread, so the read-add-write needs
//      no atomics at all (a shared float atomicAdd is a compare-and-swap
//      loop on sm_90).
// Two accumulate designs:
//   - any C (MoTIF's C = 130 compiled in): warp w owns channels 32 w ..
//     32 w + 31 of every tile pixel, one more warp the max, a lane per
//     corner. Its 32-byte records hold the corner weights (the fractional
//     position for the float16 entry, whose lanes form the float16 weights)
//     and e^z.
//   - C = 64 (the payload projected through the synthesis net's first
//     layer): one warp owns the 64 payload channels, a lane per channel
//     pair, kept as a float2 or __half2 tile word and read of each source
//     as one float2; a second warp keeps the norm and count pair and the
//     max, a lane per corner. Its records are 16 bytes (source, tile pixel
//     and corner mask, fractional position). The two warps stage a chunk
//     of records and form each record's scalars once there (e^z read by
//     source, the float32 weights, the float16 weights and e^z rounded),
//     not once per lane.
// No float atomic touches global memory, and every output is written by
// exactly one block. The list order, and so the summation order, varies
// from run to run (the fill's atomics), so out and norm match the plain
// version to rounding; the count and the max are exact. A converging flow
// makes one tile's list long and its block slow: right for any flow, fast
// for spread ones.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

struct Corners {
  int iy0, ix0;
  bool vy0, vy1, vx0, vx1;
  float wx1, wy1;  // the target's fractional position
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Corners corners(float dx, float dy, int x, int y,
                                           int H, int W) {
  Corners c;
  const float fx = (float)x + dx;
  const float fy = (float)y + dy;
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float wx1 = fx - x0;
  const float wy1 = fy - y0;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  // validity is decided in float so that huge or non-finite targets never
  // reach an int conversion
  c.vx0 = x0 >= 0.0f && x0 <= (float)(W - 1);
  c.vx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1);
  c.vy0 = y0 >= 0.0f && y0 <= (float)(H - 1);
  c.vy1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1);
  c.ix0 = (c.vx0 || c.vx1) ? (int)x0 : 0;
  c.iy0 = (c.vy0 || c.vy1) ? (int)y0 : 0;
  c.wx1 = wx1;
  c.wy1 = wy1;
  c.w00 = wy0 * wx0;
  c.w01 = wy0 * wx1;
  c.w10 = wy1 * wx0;
  c.w11 = wy1 * wx1;
  return c;
}

struct Grid {  // the target tiling
  int H, W, th, tw, ntx, per_img;
};

// A source pixel's corners and the distinct tiles that hold its in-image
// corners: tile rows r0, r1 and tile columns c0, c1 (-1 for none; r1 and
// c1 only when the two corner rows or columns fall in different tiles).
// Validity is separable (row valid and column valid), so the tiles are
// the rows of the valid corner rows times the columns of the valid corner
// columns.
struct Bins {
  Corners c;
  int b, r0, r1, c0, c1;
};

__device__ __forceinline__ Bins bins(const float* __restrict__ flow, int p,
                                     const Grid& g) {
  Bins s;
  const float2 f = __ldg(reinterpret_cast<const float2*>(flow) + p);
  s.c = corners(f.x, f.y, p % g.W, (p / g.W) % g.H, g.H, g.W);
  s.b = p / (g.H * g.W);
  s.r0 = s.r1 = s.c0 = s.c1 = -1;
  if (s.c.vy0) s.r0 = s.c.iy0 / g.th;
  if (s.c.vy1) {
    const int r = (s.c.iy0 + 1) / g.th;
    if (s.r0 < 0) s.r0 = r; else if (r != s.r0) s.r1 = r;
  }
  if (s.c.vx0) s.c0 = s.c.ix0 / g.tw;
  if (s.c.vx1) {
    const int c = (s.c.ix0 + 1) / g.tw;
    if (s.c0 < 0) s.c0 = c; else if (c != s.c0) s.c1 = c;
  }
  return s;
}

// The tile of slot k (0: r0 c0, 1: r0 c1, 2: r1 c0, 3: r1 c1), -1 if none.
__device__ __forceinline__ int tile_of(const Bins& s, int k, const Grid& g) {
  const int r = k < 2 ? s.r0 : s.r1;
  const int c = k & 1 ? s.c1 : s.c0;
  return r >= 0 && c >= 0 ? s.b * g.per_img + r * g.ntx + c : -1;
}

// What the accumulate kernel needs of one (source, tile) pair, written by
// the fill: the corner weights, the source's flat index, the tile pixel of
// corner (y0, x0) (which may lie outside the tile), the mask of the
// corners inside the tile (bit k: corner k in the order 00, 01, 10, 11)
// and e^z. RAW (the float16 entry): w holds the fractional position
// (wx1, wy1) instead, from which the accumulate kernel forms the float16
// weights for the sums and the float32 ones for the max.
struct __align__(16) Record {
  float4 w;
  int4 m;  // p, pixel, mask, e^z bits
};

// The record of the C = 64 design: p, the tile pixel and the corner mask
// as pixel * 16 + mask (the pixel may be negative), and the fractional
// position (wx1, wy1); e^z is read by p when the record is staged.
struct __align__(16) Compact {
  int p, pm;
  float wx1, wy1;
};

// Tile slot k's pixel of corner (y0, x0) and its corner mask.
__device__ __forceinline__ int2 tile_corners(const Bins& s, int k,
                                             const Grid& g) {
  const int ly = s.c.iy0 - (k < 2 ? s.r0 : s.r1) * g.th;
  const int lx = s.c.ix0 - (k & 1 ? s.c1 : s.c0) * g.tw;
  const bool in_y0 = s.c.vy0 && ly >= 0 && ly < g.th;
  const bool in_y1 = s.c.vy1 && ly + 1 >= 0 && ly + 1 < g.th;
  const bool in_x0 = s.c.vx0 && lx >= 0 && lx < g.tw;
  const bool in_x1 = s.c.vx1 && lx + 1 >= 0 && lx + 1 < g.tw;
  const int mask = (in_y0 && in_x0) | (in_y0 && in_x1) << 1 |
                   (in_y1 && in_x0) << 2 | (in_y1 && in_x1) << 3;
  return make_int2(ly * g.tw + lx, mask);
}

template <typename R, bool RAW>
__device__ __forceinline__ R record(const Bins& s, int k, int p, float e,
                                    const Grid& g) {
  const int2 pm = tile_corners(s, k, g);
  R r;
  if constexpr (sizeof(R) == sizeof(Compact)) {
    r.p = p;
    r.pm = pm.x * 16 + pm.y;
    r.wx1 = s.c.wx1;
    r.wy1 = s.c.wy1;
  } else {
    r.w = RAW ? make_float4(s.c.wx1, s.c.wy1, 0.0f, 0.0f)
              : make_float4(s.c.w00, s.c.w01, s.c.w10, s.c.w11);
    r.m = make_int4(p, pm.x, pm.y, __float_as_int(e));
  }
  return r;
}

// atomicAdd(ctr + t, 1) for every lane with t >= 0, one atomic per distinct
// t in the warp; returns the value this lane's own add would have seen.
// Every lane of the warp calls it.
__device__ __forceinline__ int warp_increment(int* ctr, int t) {
  const unsigned group = __match_any_sync(0xffffffffu, t);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(group) - 1;
  int base = 0;
  if (t >= 0 && lane == leader) base = atomicAdd(ctr + t, __popc(group));
  base = __shfl_sync(group, base, leader);
  return base + __popc(group & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(THREADS)
    count_kernel(const float* __restrict__ flow, int* __restrict__ cnt,
                 Grid g, int n_pix) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  Bins s;
  s.r0 = -1;
  if (p < n_pix) s = bins(flow, p, g);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    warp_increment(cnt, s.r0 >= 0 ? tile_of(s, k, g) : -1);
}

// R: Record (RAW: the fractional position in place of the weights) or
// Compact (which needs no e^z).
template <typename R, bool RAW>
__global__ void __launch_bounds__(THREADS)
    fill_kernel(const float* __restrict__ flow, const float* __restrict__ ez,
                int* __restrict__ cursor, R* __restrict__ rec, Grid g,
                int n_pix) {
  constexpr bool WITH_E = sizeof(R) == sizeof(Record);
  const int p = blockIdx.x * THREADS + threadIdx.x;
  Bins s;
  s.r0 = -1;
  float e = 0.0f;
  if (p < n_pix) {
    s = bins(flow, p, g);
    if (WITH_E) e = __ldg(ez + p);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = s.r0 >= 0 ? tile_of(s, k, g) : -1;
    const int slot = warp_increment(cursor, t);
    if (t >= 0) rec[slot] = record<R, RAW>(s, k, p, e, g);
  }
}

constexpr int SCAN_ROUNDS = 16;  // rounds of SCAN_THREADS counters a batch

// Exclusive prefix sum of cnt[0, n) into start[0, n], one block; cnt is
// left holding each tile's start, the cursor of the fill. Round r of a
// batch scans the SCAN_THREADS consecutive counters that start at
// base + r * SCAN_THREADS, one a thread; a batch's loads are issued
// together, so the scan waits for memory once a batch, not once a counter.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(int* __restrict__ cnt, int* __restrict__ start, int n) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += SCAN_THREADS * SCAN_ROUNDS) {
    int c[SCAN_ROUNDS];
#pragma unroll
    for (int r = 0; r < SCAN_ROUNDS; ++r) {
      const int i = base + r * SCAN_THREADS + threadIdx.x;
      c[r] = i < n ? cnt[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < SCAN_ROUNDS; ++r) {
      if (base + r * SCAN_THREADS >= n) break;  // the same in every thread
      int v = c[r];  // inclusive scan within the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      if (lane == 31) warp_sums[warp] = v;
      __syncthreads();
      if (warp == 0) {
        int w = warp_sums[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, w, d);
          if (lane >= d) w += u;
        }
        warp_sums[lane] = w;
      }
      __syncthreads();
      const int i = base + r * SCAN_THREADS + threadIdx.x;
      const int run = carry + v - c[r] + (warp > 0 ? warp_sums[warp - 1] : 0);
      if (i < n) {
        start[i] = run;
        cnt[i] = run;
      }
      carry += warp_sums[SCAN_THREADS / 32 - 1];
      __syncthreads();  // warp_sums is read before the next round writes it
    }
  }
  if (threadIdx.x == 0) start[n] = carry;
}

constexpr int CHUNK = 128;  // records a block stages at a time
constexpr int DEPTH = 8;    // img loads a lane keeps in flight
constexpr int MAX_GROUPS = 15;

// Block size of the accumulate kernel: one warp per 32 of the C + 2
// payload channels (at most MAX_GROUPS warps, which then take several
// groups each), and one warp for the max.
__host__ __device__ constexpr int acc_threads(int C) {
  return 32 * (((C + 2 + 31) / 32 < MAX_GROUPS ? (C + 2 + 31) / 32
                                                : MAX_GROUPS) + 1);
}

// The sums' type A: float, or __half with every operation rounded once.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
template <typename A>
__device__ __forceinline__ A from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
// v rounded to A, as a float
template <typename A>
__device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<A>(v));
}

// Bytes of the [npx][CP] tile of A, rounded up to the floats of the max
// that follow it.
template <typename A>
__host__ __device__ constexpr int tile_bytes(int npx, int CP) {
  return (npx * CP * (int)sizeof(A) + 3) & ~3;
}

// The block's tile of the accumulate kernel: [npx][CP] sums of type A,
// then the max [npx] floats, after the staged records.
template <typename A>
__device__ __forceinline__ void zero_tile(A* tile, int npx, int CP,
                                          int nthreads) {
  const int bytes = tile_bytes<A>(npx, CP);
  float* const tmax = reinterpret_cast<float*>(
      reinterpret_cast<char*>(tile) + bytes);
  uint4* const tile16 = reinterpret_cast<uint4*>(tile);
  unsigned* const tile4 = reinterpret_cast<unsigned*>(tile);
  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < bytes / 16; i += nthreads) tile16[i] = z4;
  for (int i = bytes / 16 * 4 + threadIdx.x; i < bytes / 4; i += nthreads)
    tile4[i] = 0u;
  for (int i = threadIdx.x; i < npx; i += nthreads) tmax[i] = 1.0f;
}

// Two neighbouring sums of the tile as a float2.
__device__ __forceinline__ float2 to_float2(const float* v) {
  return *reinterpret_cast<const float2*>(v);
}
__device__ __forceinline__ float2 to_float2(const __half* v) {
  return __half22float2(*reinterpret_cast<const __half2*>(v));
}

// The tile's in-image pixels to acc and zmax (float32 both): one
// contiguous run of cols * CP floats per tile row in both, 16 bytes at a
// time when the tile holds floats and CP is a multiple of 4, else 8 bytes
// at a time when CP is even.
template <typename A>
__device__ __forceinline__ void store_tile(const A* tile, float* acc,
                                           float* zmax, const Grid& g, int b,
                                           int ty0, int tx0, int CP,
                                           int nthreads) {
  const int th = g.th, tw = g.tw;
  const float* const tmax = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(tile) + tile_bytes<A>(th * tw, CP));
  const int rows = min(th, g.H - ty0);
  const int cols = min(tw, g.W - tx0);
  const long long pix0 = (long long)b * g.H * g.W;
  if (sizeof(A) == 4 && CP % 4 == 0) {
    const float4* const tile4 = reinterpret_cast<const float4*>(tile);
    const int per_row = cols * CP / 4;
    for (int j = threadIdx.x; j < rows * per_row; j += nthreads) {
      const int r = j / per_row;
      const int k = j - r * per_row;
      float4* dst = reinterpret_cast<float4*>(
          acc + (pix0 + (long long)(ty0 + r) * g.W + tx0) * CP);
      dst[k] = tile4[r * tw * CP / 4 + k];
    }
  } else if (CP % 2 == 0) {
    const int per_row = cols * CP / 2;
    for (int j = threadIdx.x; j < rows * per_row; j += nthreads) {
      const int r = j / per_row;
      const int k = j - r * per_row;
      float2* dst = reinterpret_cast<float2*>(
          acc + (pix0 + (long long)(ty0 + r) * g.W + tx0) * CP);
      dst[k] = to_float2(tile + r * tw * CP + 2 * k);
    }
  } else {
    const int per_row = cols * CP;
    for (int j = threadIdx.x; j < rows * per_row; j += nthreads) {
      const int r = j / per_row;
      const int k = j - r * per_row;
      acc[(pix0 + (long long)(ty0 + r) * g.W + tx0) * CP + k] =
          to_float(tile[r * tw * CP + k]);
    }
  }
  for (int j = threadIdx.x; j < rows * cols; j += nthreads) {
    const int r = j / cols;
    const int k = j - r * cols;
    zmax[pix0 + (long long)(ty0 + r) * g.W + tx0 + k] = tmax[r * tw + k];
  }
}

// The float32 corner weights from the fractional position, as corners()
// forms them.
__device__ __forceinline__ float4 float_weights(float wx1, float wy1) {
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  return make_float4(__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                     __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1));
}

// The float16 corner weights, as floats: the factors rounded to float16,
// then each product.
__device__ __forceinline__ float4 half_weights(float wx1f, float wy1f) {
  const float wx1 = rnd<__half>(wx1f);
  const float wy1 = rnd<__half>(wy1f);
  const float wx0 = rnd<__half>(1.0f - wx1);
  const float wy0 = rnd<__half>(1.0f - wy1);
  return make_float4(
      rnd<__half>(__fmul_rn(wy0, wx0)), rnd<__half>(__fmul_rn(wy0, wx1)),
      rnd<__half>(__fmul_rn(wy1, wx0)), rnd<__half>(__fmul_rn(wy1, wx1)));
}

// w's component k, by selects (an indexed pick becomes a jump table)
__device__ __forceinline__ float pick(const float4& w, int k) {
  const float lo = k & 1 ? w.y : w.x;
  const float hi = k & 1 ? w.w : w.z;
  return k & 2 ? hi : lo;
}

// One block per tile. The payload [img * e^z | e^z | 1] of every listed
// source is added into the source's corners in this tile. Warp w owns
// channels 32 w + lane (and + 32 * (warps - 1), ...) of every tile pixel,
// so no two threads ever add into the same word: plain shared loads and
// stores, no atomics (a shared float atomicAdd is a compare-and-swap loop
// on sm_90). The last warp keeps the max, one lane per corner. The
// records are staged CHUNK at a time; each channel warp walks the chunk
// with the img loads of the next DEPTH sources in flight. The summation
// order is the list order, which the fill's atomics make vary from run to
// run. CT is C where it is known at compile time (MoTIF's 130), else 0.
// A is the sums' type; with __half the records hold the fractional
// position (fill_kernel<Record, true>).
template <int CT, bool MAX, typename A>
__global__ void __launch_bounds__(CT ? acc_threads(CT) : 512)
    accumulate_kernel(const float* __restrict__ img,
                      const int* __restrict__ start,
                      const Record* __restrict__ rec,
                      float* __restrict__ acc, float* __restrict__ zmax,
                      Grid g, int c_any) {
  extern __shared__ float4 smem[];
  const int C = CT ? CT : c_any;
  const int CP = C + 2;
  const int th = g.th, tw = g.tw;
  const int npx = th * tw;
  const int nthreads = CT ? acc_threads(CT) : blockDim.x;
  float4* const cw = smem;                                 // [CHUNK]
  int4* const cm = reinterpret_cast<int4*>(smem + CHUNK);  // [CHUNK]
  constexpr bool HALF = sizeof(A) == 2;
  A* const tile = reinterpret_cast<A*>(smem + 2 * CHUNK);  // [npx][CP]
  float* const tmax = reinterpret_cast<float*>(
      reinterpret_cast<char*>(tile) + tile_bytes<A>(npx, CP));  // [npx]

  const int t = blockIdx.x;
  const int b = t / g.per_img;
  const int rc = t - b * g.per_img;
  const int ty0 = (rc / g.ntx) * th;
  const int tx0 = (rc % g.ntx) * tw;
  zero_tile(tile, npx, CP, nthreads);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int max_warp = (nthreads >> 5) - 1;
  const int groups = (CP + 31) >> 5;
  const int beg = start[t], end = start[t + 1];
  for (int c0 = beg; c0 < end; c0 += CHUNK) {
    const int n = min(CHUNK, end - c0);
    __syncthreads();  // the previous chunk is consumed (or the tile zeroed)
    for (int j = threadIdx.x; j < n; j += nthreads) {
      cw[j] = __ldg(&rec[c0 + j].w);
      cm[j] = __ldg(&rec[c0 + j].m);
    }
    __syncthreads();
    if (warp == max_warp) {
      if (!MAX || lane >= 4) continue;
      const int dq = (lane >> 1) * tw + (lane & 1);
      for (int j = 0; j < n; ++j) {
        const int4 m = cm[j];
        if (m.z >> lane & 1) {
          float* const q = tmax + m.y + dq;
          const float4 w = HALF ? float_weights(cw[j].x, cw[j].y) : cw[j];
          *q = fmaxf(*q, __fmul_rn(__int_as_float(m.w), pick(w, lane)));
        }
      }
      continue;
    }
    for (int grp = warp; grp < groups; grp += max_warp) {
      const int ch = 32 * grp + lane;
      if (ch >= CP) continue;  // the last group's idle lanes
      const bool count = ch == C + 1;
      const bool pay = ch < C;
      float buf[DEPTH];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d)
        buf[d] = pay && d < n ? __ldg(img + (long long)cm[d].x * C + ch)
                              : 0.0f;
      for (int j0 = 0; j0 < n; j0 += DEPTH) {
        float nxt[DEPTH];
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          const int j = j0 + DEPTH + d;
          nxt[d] = pay && j < n ? __ldg(img + (long long)cm[j].x * C + ch)
                                : 0.0f;
        }
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          const int j = j0 + d;
          if (j >= n) break;
          const float4 w = HALF ? half_weights(cw[j].x, cw[j].y) : cw[j];
          const int4 m = cm[j];
          const float e = rnd<A>(__int_as_float(m.w));
          // the plain version's rounding: (img * e^z) * w, then the add,
          // each rounded to A; the four corners are read before any is
          // written back
          const float v = pay ? rnd<A>(__fmul_rn(rnd<A>(buf[d]), e)) : e;
          A* const a00 = tile + m.y * CP + ch;
          A* const a10 = a00 + tw * CP;
          const float s00 = m.z & 1 ? to_float(*a00) : 0.0f;
          const float s01 = m.z & 2 ? to_float(a00[CP]) : 0.0f;
          const float s10 = m.z & 4 ? to_float(*a10) : 0.0f;
          const float s11 = m.z & 8 ? to_float(a10[CP]) : 0.0f;
          if (m.z & 1)
            *a00 = from_float<A>(
                s00 + (count ? 1.0f : rnd<A>(__fmul_rn(v, w.x))));
          if (m.z & 2)
            a00[CP] = from_float<A>(
                s01 + (count ? 1.0f : rnd<A>(__fmul_rn(v, w.y))));
          if (m.z & 4)
            *a10 = from_float<A>(
                s10 + (count ? 1.0f : rnd<A>(__fmul_rn(v, w.z))));
          if (m.z & 8)
            a10[CP] = from_float<A>(
                s11 + (count ? 1.0f : rnd<A>(__fmul_rn(v, w.w))));
        }
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) buf[d] = nxt[d];
      }
    }
  }
  __syncthreads();
  store_tile(tile, acc, zmax, g, b, ty0, tx0, CP, nthreads);
}

// ---- the C = 64 design ----------------------------------------------------

constexpr int PAIR_C = 64;             // the payload width of this design
constexpr int PAIRS = PAIR_C / 2 + 1;  // tile words a pixel: 32, norm+count
constexpr int PAIR_CHUNK = 64;         // records staged at a time, 1 a thread
constexpr int PAIR_DEPTH = 8;          // img loads in flight (payload warp)

// A staged record: what every lane needs of it, formed once. float32 sums:
// e^z and the float32 corner weights. float16 sums: e^z (for the max) and
// e^z rounded to float16 as a pair, the float16 corner weights each as a
// pair (what __hmul2_rn takes), and the float32 weights for the max.
template <typename A>
struct Staged;
template <>
struct Staged<float> {
  int p, pm;
  float e, pad;
  float4 w;
};
template <>
struct Staged<__half> {
  int p, pm;
  float e;
  __half2 eh;
  __half2 w[4];
  float4 wf;
};

__device__ __forceinline__ void stage(Staged<float>& st, int p, int pm,
                                      float e, float wx1, float wy1) {
  st.p = p;
  st.pm = pm;
  st.e = e;
  st.w = float_weights(wx1, wy1);
}
__device__ __forceinline__ void stage(Staged<__half>& st, int p, int pm,
                                      float e, float wx1, float wy1) {
  st.p = p;
  st.pm = pm;
  st.e = e;
  st.eh = __float2half2_rn(e);
  const float4 wh = half_weights(wx1, wy1);  // exact in float16
  st.w[0] = __float2half2_rn(wh.x);
  st.w[1] = __float2half2_rn(wh.y);
  st.w[2] = __float2half2_rn(wh.z);
  st.w[3] = __float2half2_rn(wh.w);
  st.wf = float_weights(wx1, wy1);
}

// The source's channel pair times e^z, in the sums' type: float32
// products, or the pair rounded to float16 and multiplied in float16.
__device__ __forceinline__ float2 payload(float2 x, const Staged<float>& st) {
  return make_float2(__fmul_rn(x.x, st.e), __fmul_rn(x.y, st.e));
}
__device__ __forceinline__ __half2 payload(float2 x,
                                           const Staged<__half>& st) {
  return __hmul2_rn(__float22half2_rn(x), st.eh);
}

// s + v * w_k, the product rounded before the add (no fused multiply-add:
// the plain version rounds both)
template <int K>
__device__ __forceinline__ float2 add_term(float2 s, float2 v,
                                           const Staged<float>& st) {
  const float w = K == 0 ? st.w.x : K == 1 ? st.w.y : K == 2 ? st.w.z
                                                             : st.w.w;
  return make_float2(s.x + __fmul_rn(v.x, w), s.y + __fmul_rn(v.y, w));
}
template <int K>
__device__ __forceinline__ __half2 add_term(__half2 s, __half2 v,
                                            const Staged<__half>& st) {
  return __hadd2(s, __hmul2_rn(v, st.w[K]));
}

// The (norm, count) pair plus corner k's (e^z * w_k, 1), and corner k's
// term of the max, e^z * w_k on the float32 weights.
__device__ __forceinline__ float2 add_norm(float2 s, const Staged<float>& st,
                                           int k) {
  return make_float2(s.x + __fmul_rn(st.e, pick(st.w, k)), s.y + 1.0f);
}
__device__ __forceinline__ __half2 add_norm(__half2 s,
                                            const Staged<__half>& st, int k) {
  const __half2 w = k & 2 ? (k & 1 ? st.w[3] : st.w[2])
                          : (k & 1 ? st.w[1] : st.w[0]);
  return __hadd2(s, __halves2half2(__hmul_rn(__low2half(st.eh),
                                             __low2half(w)),
                                   __float2half_rn(1.0f)));
}
__device__ __forceinline__ float max_term(const Staged<float>& st, int k) {
  return __fmul_rn(st.e, pick(st.w, k));
}
__device__ __forceinline__ float max_term(const Staged<__half>& st, int k) {
  return __fmul_rn(st.e, pick(st.wf, k));
}

// One block of two warps per tile, C = 64. Warp 0 owns the 64 payload
// channels of every tile pixel, lane l the pair (2 l, 2 l + 1): it reads
// the pair of each listed source as one float2, forms [img * e^z] once
// for the pair and adds it times each corner's weight into that corner's
// word, the img loads of the next PAIR_DEPTH sources in flight (a rolling
// window: the load into a register is issued right after its value is
// used). Warp 1, lane k < 4, owns corner k: it adds (e^z * w_k, 1) into
// the corner's (norm, count) word and keeps the max. No word has two
// owners, so there are no atomics; the sums run in list order. Both warps
// stage each chunk of PAIR_CHUNK records, one a thread, reading e^z by
// source and forming the record's scalars once. P is the tile word, a
// float2 or a __half2.
template <bool MAX, typename A>
__global__ void __launch_bounds__(64)
    accumulate_pairs_kernel(const float* __restrict__ img,
                            const float* __restrict__ ez,
                            const int* __restrict__ start,
                            const Compact* __restrict__ rec,
                            float* __restrict__ acc,
                            float* __restrict__ zmax, Grid g) {
  using P = std::conditional_t<sizeof(A) == 2, __half2, float2>;
  extern __shared__ float4 smem[];
  const int th = g.th, tw = g.tw;
  const int npx = th * tw;
  Staged<A>* const st = reinterpret_cast<Staged<A>*>(smem);  // [PAIR_CHUNK]
  P* const tile = reinterpret_cast<P*>(st + PAIR_CHUNK);     // [npx][PAIRS]
  float* const tmax = reinterpret_cast<float*>(tile + npx * PAIRS);  // [npx]

  const int t = blockIdx.x;
  const int b = t / g.per_img;
  const int rc = t - b * g.per_img;
  const int ty0 = (rc / g.ntx) * th;
  const int tx0 = (rc % g.ntx) * tw;
  zero_tile(reinterpret_cast<A*>(tile), npx, 2 * PAIRS, 64);

  const int lane = threadIdx.x & 31;
  const int beg = start[t], end = start[t + 1];
  const float2* const img2 = reinterpret_cast<const float2*>(img) + lane;
  for (int c0 = beg; c0 < end; c0 += PAIR_CHUNK) {
    const int n = min(PAIR_CHUNK, end - c0);
    __syncthreads();  // the previous chunk is consumed (or the tile zeroed)
    if (threadIdx.x < n) {
      const Compact r = rec[c0 + threadIdx.x];
      stage(st[threadIdx.x], r.p, r.pm, __ldg(ez + r.p), r.wx1, r.wy1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      float2 buf[PAIR_DEPTH];
#pragma unroll
      for (int d = 0; d < PAIR_DEPTH; ++d)
        buf[d] = d < n ? __ldg(img2 + (long long)st[d].p * (PAIR_C / 2))
                       : make_float2(0.0f, 0.0f);
      for (int j0 = 0; j0 < n; j0 += PAIR_DEPTH) {
#pragma unroll
        for (int d = 0; d < PAIR_DEPTH; ++d) {
          const int j = j0 + d;
          if (j >= n) break;
          const Staged<A> r = st[j];  // a copy: tile stores alias st
          const P v = payload(buf[d], r);
          if (j + PAIR_DEPTH < n)
            buf[d] = __ldg(img2 + (long long)st[j + PAIR_DEPTH].p *
                                      (PAIR_C / 2));
          const int pm = r.pm;
          P* const q00 = tile + (pm >> 4) * PAIRS + lane;
          P* const q10 = q00 + tw * PAIRS;
          if (pm & 1) *q00 = add_term<0>(*q00, v, r);
          if (pm & 2) q00[PAIRS] = add_term<1>(q00[PAIRS], v, r);
          if (pm & 4) *q10 = add_term<2>(*q10, v, r);
          if (pm & 8) q10[PAIRS] = add_term<3>(q10[PAIRS], v, r);
        }
      }
    } else if (lane < 4) {
      const int dq = (lane >> 1) * tw + (lane & 1);
      for (int j = 0; j < n; ++j) {
        const Staged<A> r = st[j];  // a copy: tile stores alias st
        const int pm = r.pm;
        if (pm >> lane & 1) {
          const int q = (pm >> 4) + dq;
          P* const s = tile + q * PAIRS + PAIR_C / 2;
          *s = add_norm(*s, r, lane);
          if (MAX) tmax[q] = fmaxf(tmax[q], max_term(r, lane));
        }
      }
    }
  }
  __syncthreads();
  store_tile(reinterpret_cast<const A*>(tile), acc, zmax, g, b, ty0, tx0,
             2 * PAIRS, 64);
}

// Lets Kernel take up to SMEM_LIMIT bytes of dynamic shared memory (a wide
// C needs more than the default 48 KB). Once per kernel.
template <auto Kernel>
cudaError_t allow_all_shared_memory() {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  return err;
}

template <int CT, bool MAX, typename A>
cudaError_t accumulate(const float* img, const int* start, const Record* rec,
                       float* acc, float* zmax, const Grid& g, int C,
                       int n_tiles, cudaStream_t s) {
  const cudaError_t err =
      allow_all_shared_memory<accumulate_kernel<CT, MAX, A>>();
  if (err != cudaSuccess) return err;
  const int npx = g.th * g.tw;
  const size_t smem = 2 * CHUNK * sizeof(float4) +
                      (size_t)tile_bytes<A>(npx, C + 2) + npx * sizeof(float);
  accumulate_kernel<CT, MAX, A><<<n_tiles, acc_threads(C), smem, s>>>(
      img, start, rec, acc, zmax, g, C);
  return cudaGetLastError();
}

// The accumulate kernel for sums of type A: C = 130 (MoTIF's payload:
// 64 + 2 + 64 channels) is compiled in; any other C but 64 is generic.
template <typename A>
cudaError_t accumulate_any(const float* img, const int* start,
                           const Record* rec, float* acc, float* zmax,
                           const Grid& g, int C, int n_tiles, bool with_max,
                           cudaStream_t s) {
#define SPLAT_ACC(CT)                                                       \
  (with_max ? accumulate<CT, true, A>(img, start, rec, acc, zmax, g, C,     \
                                      n_tiles, s)                           \
            : accumulate<CT, false, A>(img, start, rec, acc, zmax, g, C,    \
                                       n_tiles, s))
  if (C == 130) return SPLAT_ACC(130);
  return SPLAT_ACC(0);
#undef SPLAT_ACC
}

template <bool MAX, typename A>
cudaError_t accumulate_pairs(const float* img, const float* ez,
                             const int* start, const Compact* rec, float* acc,
                             float* zmax, const Grid& g, int n_tiles,
                             cudaStream_t s) {
  const cudaError_t err =
      allow_all_shared_memory<accumulate_pairs_kernel<MAX, A>>();
  if (err != cudaSuccess) return err;
  const int npx = g.th * g.tw;
  const size_t smem = PAIR_CHUNK * sizeof(Staged<A>) +
                      npx * (PAIRS * 2 * sizeof(A) + sizeof(float));
  accumulate_pairs_kernel<MAX, A><<<n_tiles, 64, smem, s>>>(
      img, ez, start, rec, acc, zmax, g);
  return cudaGetLastError();
}

// The C = 64 design for sums of type A (the payload projected through the
// synthesis net's first layer).
template <typename A>
cudaError_t accumulate_64(const float* img, const float* ez, const int* start,
                          const Compact* rec, float* acc, float* zmax,
                          const Grid& g, int n_tiles, bool with_max,
                          cudaStream_t s) {
  return with_max ? accumulate_pairs<true, A>(img, ez, start, rec, acc, zmax,
                                              g, n_tiles, s)
                  : accumulate_pairs<false, A>(img, ez, start, rec, acc,
                                               zmax, g, n_tiles, s);
}

}  // namespace

// One splat: memset, count, scan, fill and accumulate on `stream`. `work`
// holds 4 * B * H * W record slots of 32 bytes (C = 64 uses the first half
// for its 16-byte records), then n_tiles counters and n_tiles + 1 offsets
// (ints). half_acc: the float16 entry. The caller checks that the tile
// (th * tw pixels of C + 2 sums of 4 or 2 bytes and a float) fits in
// SMEM_LIMIT bytes beside the staged records and that 4 * B * H * W fits
// in an int.
extern "C" int splat_fused_forward(const float* img, const float* flow,
                                   const float* ez, float* acc, float* zmax,
                                   void* work, int B, int H, int W, int C,
                                   int th, int tw, int with_max, int half_acc,
                                   void* stream) {
  const int n_pix = B * H * W;
  if (n_pix == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  Grid g;
  g.H = H;
  g.W = W;
  g.th = th;
  g.tw = tw;
  g.ntx = (W + tw - 1) / tw;
  g.per_img = ((H + th - 1) / th) * g.ntx;
  const int n_tiles = B * g.per_img;
  Record* const rec = static_cast<Record*>(work);
  int* const cnt = reinterpret_cast<int*>(rec + 4 * (long long)n_pix);
  int* const start = cnt + n_tiles;
  cudaError_t err = cudaMemsetAsync(cnt, 0, n_tiles * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_pix + THREADS - 1) / THREADS;
  count_kernel<<<blocks, THREADS, 0, s>>>(flow, cnt, g, n_pix);
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(cnt, start, n_tiles);
  Compact* const compact = static_cast<Compact*>(work);
  if (C == PAIR_C)
    fill_kernel<Compact, false><<<blocks, THREADS, 0, s>>>(flow, ez, cnt,
                                                           compact, g, n_pix);
  else if (half_acc)
    fill_kernel<Record, true><<<blocks, THREADS, 0, s>>>(flow, ez, cnt, rec, g,
                                                         n_pix);
  else
    fill_kernel<Record, false><<<blocks, THREADS, 0, s>>>(flow, ez, cnt, rec,
                                                          g, n_pix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool mx = with_max != 0;
  if (C == PAIR_C)
    err = half_acc ? accumulate_64<__half>(img, ez, start, compact, acc, zmax,
                                           g, n_tiles, mx, s)
                   : accumulate_64<float>(img, ez, start, compact, acc, zmax,
                                          g, n_tiles, mx, s);
  else
    err = half_acc ? accumulate_any<__half>(img, start, rec, acc, zmax, g, C,
                                            n_tiles, mx, s)
                   : accumulate_any<float>(img, start, rec, acc, zmax, g, C,
                                           n_tiles, mx, s);
  return (int)err;
}
