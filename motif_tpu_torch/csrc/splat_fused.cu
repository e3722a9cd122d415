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
// Layout (NHWC, float32, contiguous):
//   img  (B, H, W, C)   flow (B, H, W, 2) = (dx, dy)   ez (B, H, W)
//   acc  (B, H, W, C + 2): channels [0, C) the splatted img * e^z, C the
//        norm (splatted e^z), C + 1 the count. Written whole: no fill.
//   zmax (B, H, W): max(1, max over corners of e^z * w), or 1 everywhere
//        when the caller skips the max (z <= 0 makes it 1). Written whole.
//   work scratch: 4 * B * H * W records of 32 bytes (the tile lists; a
//        source is listed in at most 4 tiles), then n_tiles counters and
//        n_tiles + 1 list offsets (ints).
//
// Bound on an H100: memory. Each source pixel reads C + 3 floats and each
// target pixel is written once, C + 3 floats (C + 2 without the max):
// 0.22 ms at 3.35 TB/s for 6 x 256 x 448 x 130. About 9 flops per channel
// and source, ~1 flop per byte moved, far below the card's fp32 rate.
//
// Design: the TPU kernel accumulates each output row block on chip and
// writes it once (a VMEM ring of the target rows a source row can reach).
// A Hopper block has 227 KB of shared memory, less than one full-width row
// at C = 130, so the targets are cut into TH x TW tiles instead (8 x 8 for
// MoTIF: 38 KB, five blocks per SM), and the sources are binned by the
// tiles their corners reach, which puts no limit on the flow. A memset of
// the counters and four kernels on the caller's stream:
//   1. count: one thread per source pixel adds 1 to the counter of each
//      distinct tile (1, 2 or 4) that holds one of its in-image corners;
//      lanes of a warp that hit the same tile share one atomicAdd;
//   2. scan: one block turns the counters into list offsets;
//   3. fill: the same walk writes a record per (source, tile) into that
//      tile's list (its corner weights, e^z, its index and which of its
//      corners lie in the tile), the slot from an atomic cursor: integer
//      atomics on n_tiles ints;
//   4. accumulate: one block per tile zeroes a [TH * TW, C + 2] float tile
//      and a ones tile for the max in shared memory and walks its list.
//      Warp w owns channels 32 w .. 32 w + 31 of every tile pixel and
//      reads them of each listed source, coalesced, so no two threads add
//      into one word: plain shared loads and stores, no atomics at all (a
//      shared float atomicAdd is a compare-and-swap loop on sm_90). One
//      more warp keeps the max, a lane per corner. Then the tile's in-image
//      pixels go to acc and zmax, 16 bytes at a time when C + 2 is a
//      multiple of 4.
// No float atomic touches global memory, and every output is written by
// exactly one block. The list order, and so the summation order, varies
// from run to run (the fill's atomics), so out and norm match the plain
// version to rounding; the count and the max are exact. A converging flow
// makes one tile's list long and its block slow: right for any flow, fast
// for spread ones.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

struct Corners {
  int iy0, ix0;
  bool vy0, vy1, vx0, vx1;
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
// and e^z.
struct __align__(16) Record {
  float4 w;
  int4 m;  // p, pixel, mask, e^z bits
};

__device__ __forceinline__ Record record(const Bins& s, int k, int p,
                                         float e, const Grid& g) {
  const int ly = s.c.iy0 - (k < 2 ? s.r0 : s.r1) * g.th;
  const int lx = s.c.ix0 - (k & 1 ? s.c1 : s.c0) * g.tw;
  const bool in_y0 = s.c.vy0 && ly >= 0 && ly < g.th;
  const bool in_y1 = s.c.vy1 && ly + 1 >= 0 && ly + 1 < g.th;
  const bool in_x0 = s.c.vx0 && lx >= 0 && lx < g.tw;
  const bool in_x1 = s.c.vx1 && lx + 1 >= 0 && lx + 1 < g.tw;
  const int mask = (in_y0 && in_x0) | (in_y0 && in_x1) << 1 |
                   (in_y1 && in_x0) << 2 | (in_y1 && in_x1) << 3;
  Record r;
  r.w = make_float4(s.c.w00, s.c.w01, s.c.w10, s.c.w11);
  r.m = make_int4(p, ly * g.tw + lx, mask, __float_as_int(e));
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

__global__ void __launch_bounds__(THREADS)
    fill_kernel(const float* __restrict__ flow, const float* __restrict__ ez,
                int* __restrict__ cursor, Record* __restrict__ rec, Grid g,
                int n_pix) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  Bins s;
  s.r0 = -1;
  float e = 0.0f;
  if (p < n_pix) {
    s = bins(flow, p, g);
    e = __ldg(ez + p);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = s.r0 >= 0 ? tile_of(s, k, g) : -1;
    const int slot = warp_increment(cursor, t);
    if (t >= 0) rec[slot] = record(s, k, p, e, g);
  }
}

// Exclusive prefix sum of cnt[0, n) into start[0, n], one block; cnt is
// left holding each tile's start, the cursor of the fill.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(int* __restrict__ cnt, int* __restrict__ start, int n) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += cnt[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int v = s;  // inclusive scan within the warp
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
  int run = v - s + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = cnt[i];
    start[i] = run;
    cnt[i] = run;
    run += c;
  }
  if (threadIdx.x == SCAN_THREADS - 1) start[n] = run;
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

// The block's tile of the accumulate kernel: [npx][CP] floats, then the
// max [npx], after the staged records.
__device__ __forceinline__ void zero_tile(float* tile, int npx, int CP,
                                          int nthreads) {
  float* const tmax = tile + npx * CP;
  if (CP % 4 == 0) {
    float4* const tile4 = reinterpret_cast<float4*>(tile);
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < npx * CP / 4; i += nthreads) tile4[i] = z4;
  } else {
    for (int i = threadIdx.x; i < npx * CP; i += nthreads) tile[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < npx; i += nthreads) tmax[i] = 1.0f;
}

// The tile's in-image pixels to acc and zmax: one contiguous run of
// cols * CP floats per tile row in both, 16 bytes at a time when CP is a
// multiple of 4.
__device__ __forceinline__ void store_tile(const float* tile, float* acc,
                                           float* zmax, const Grid& g, int b,
                                           int ty0, int tx0, int CP,
                                           int nthreads) {
  const int th = g.th, tw = g.tw;
  const float* const tmax = tile + th * tw * CP;
  const int rows = min(th, g.H - ty0);
  const int cols = min(tw, g.W - tx0);
  const long long pix0 = (long long)b * g.H * g.W;
  if (CP % 4 == 0) {
    const float4* const tile4 = reinterpret_cast<const float4*>(tile);
    const int per_row = cols * CP / 4;
    for (int j = threadIdx.x; j < rows * per_row; j += nthreads) {
      const int r = j / per_row;
      const int k = j - r * per_row;
      float4* dst = reinterpret_cast<float4*>(
          acc + (pix0 + (long long)(ty0 + r) * g.W + tx0) * CP);
      dst[k] = tile4[r * tw * CP / 4 + k];
    }
  } else {
    const int per_row = cols * CP;
    for (int j = threadIdx.x; j < rows * per_row; j += nthreads) {
      const int r = j / per_row;
      const int k = j - r * per_row;
      acc[(pix0 + (long long)(ty0 + r) * g.W + tx0) * CP + k] =
          tile[r * tw * CP + k];
    }
  }
  for (int j = threadIdx.x; j < rows * cols; j += nthreads) {
    const int r = j / cols;
    const int k = j - r * cols;
    zmax[pix0 + (long long)(ty0 + r) * g.W + tx0 + k] = tmax[r * tw + k];
  }
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
template <int CT, bool MAX>
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
  float* const tile = reinterpret_cast<float*>(smem + 2 * CHUNK);  // [npx][CP]
  float* const tmax = tile + npx * CP;                     // [npx]

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
          *q = fmaxf(*q, __fmul_rn(__int_as_float(m.w), pick(cw[j], lane)));
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
          const float4 w = cw[j];
          const int4 m = cm[j];
          const float e = __int_as_float(m.w);
          // the plain version's rounding: (img * e^z) * w, then the add;
          // the four corners are read before any is written back
          const float v = pay ? __fmul_rn(buf[d], e) : e;
          float* const a00 = tile + m.y * CP + ch;
          float* const a10 = a00 + tw * CP;
          const float s00 = m.z & 1 ? *a00 : 0.0f;
          const float s01 = m.z & 2 ? a00[CP] : 0.0f;
          const float s10 = m.z & 4 ? *a10 : 0.0f;
          const float s11 = m.z & 8 ? a10[CP] : 0.0f;
          if (m.z & 1) *a00 = s00 + (count ? 1.0f : __fmul_rn(v, w.x));
          if (m.z & 2) a00[CP] = s01 + (count ? 1.0f : __fmul_rn(v, w.y));
          if (m.z & 4) *a10 = s10 + (count ? 1.0f : __fmul_rn(v, w.z));
          if (m.z & 8) a10[CP] = s11 + (count ? 1.0f : __fmul_rn(v, w.w));
        }
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) buf[d] = nxt[d];
      }
    }
  }
  __syncthreads();
  store_tile(tile, acc, zmax, g, b, ty0, tx0, CP, nthreads);
}

// Lets Kernel take up to SMEM_LIMIT bytes of dynamic shared memory (a wide
// C needs more than the default 48 KB). Once per kernel.
template <auto Kernel>
cudaError_t allow_all_shared_memory() {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  return err;
}

template <int CT, bool MAX>
cudaError_t accumulate(const float* img, const int* start, const Record* rec,
                       float* acc, float* zmax, const Grid& g, int C,
                       int n_tiles, cudaStream_t s) {
  const cudaError_t err = allow_all_shared_memory<accumulate_kernel<CT, MAX>>();
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * CHUNK * sizeof(float4) +
                      (size_t)g.th * g.tw * (C + 3) * sizeof(float);
  accumulate_kernel<CT, MAX><<<n_tiles, acc_threads(C), smem, s>>>(
      img, start, rec, acc, zmax, g, C);
  return cudaGetLastError();
}

}  // namespace

// One splat: memset, count, scan, fill and accumulate on `stream`. `work`
// holds 4 * B * H * W records of 32 bytes, then n_tiles counters and
// n_tiles + 1 offsets (ints). The caller checks that th * tw * (C + 3)
// floats fit in SMEM_LIMIT bytes and that 4 * B * H * W fits in an int.
extern "C" int splat_fused_forward(const float* img, const float* flow,
                                   const float* ez, float* acc, float* zmax,
                                   void* work, int B, int H, int W, int C,
                                   int th, int tw, int with_max,
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
  fill_kernel<<<blocks, THREADS, 0, s>>>(flow, ez, cnt, rec, g, n_pix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (C == 130)  // MoTIF's payload: 64 + 2 + 64 channels
    err = with_max ? accumulate<130, true>(img, start, rec, acc, zmax, g, C,
                                           n_tiles, s)
                   : accumulate<130, false>(img, start, rec, acc, zmax, g,
                                            C, n_tiles, s);
  else
    err = with_max ? accumulate<0, true>(img, start, rec, acc, zmax, g, C,
                                         n_tiles, s)
                   : accumulate<0, false>(img, start, rec, acc, zmax, g, C,
                                          n_tiles, s);
  return (int)err;
}
