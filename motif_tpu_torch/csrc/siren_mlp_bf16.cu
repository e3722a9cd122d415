// siren_mlp, bfloat16 entries: a whole SIREN MLP per 16-token warp tile on
// the tensor cores, the weights resident in shared memory and the hidden
// activations resident in registers: h = sin(omega0 * (h W + b)) for every
// layer, the last one linear unless sine_last; with skip_first the MLP
// starts with sin(omega0 * x) on the first layer's pre-activation.
//
// Replaces the TPU kernel motif_tpu/ops/siren_kernel.py::_kernel (behind
// siren_fused) for bfloat16 tokens, which contracts on the matrix unit
// (jnp.dot with a float32 result). The float32 entries are siren_mlp.cu.
//
// Numbers: what the plain bfloat16 version computes. Per layer the product
// accumulates in float32 and a value is rounded to bfloat16 after the
// product, after the bias, after omega0 * and after the sine; the sine is
// sinf bit for bit (sine.cuh; its slow path for wide arguments is kept
// out of line, which made the kernel 5-7% faster on an H100). The one
// difference from the plain version is the ORDER of the float32
// accumulation, which is the tensor core's
// (and, for a layer wider than 64 that feeds the next one, 64 columns at a
// time): a sum that lands on a bfloat16 rounding boundary may round the
// other way, and omega0 and the sines after it amplify that, so the kernel
// is held to its plain version by accuracy against a float64 evaluation
// and not by equality.
//
// Contraction: mma.sync.aligned.m16n8k16 (bf16 x bf16 -> f32) fed by
// ldmatrix, not wgmma. With the products at 29-35 GFLOP per launch the
// tensor cores need ~0.04 ms at their peak, while the sines (384 a token
// for STINF at ~20 fp32-pipe instructions each) and the four roundings
// need several times that on the fp32 pipe: mma.sync at a fraction of the
// wgmma rate is not what bounds the kernel. And mma.sync's accumulator
// fragment of one layer is, rounded and packed, the A fragment of the next
// (mma.cuh), which wgmma's 64-row tiles spread over four warps are too,
// but only at the cost of warpgroup-wide synchronisation.
//
// Design:
// - Persistent blocks, one per SM, 16 warps. A block copies every layer's
//   weights into shared memory once; then its warps run free: each takes
//   16-token tiles of its own (tile index = global warp index, strided by
//   the number of warps in the grid) through the whole MLP with no block
//   barrier. A token's result depends on nothing but its own row.
// - x: each warp stages its 16 rows into its own zero-padded row-major
//   slab (rows pad16(K0) + 8 elements apart, ldmatrix-ready). Rows of a
//   multiple of 8 elements are 16-byte aligned and come by cp.async, double
//   buffered, so the next tile's rows load under this tile's sines; other
//   widths (67, 66, 198) come by 2-byte loads into a single slab.
// - Layer 0 of the whole entry reads its A fragments from the slab
//   (ldmatrix); the skip-first entry loads the slab into A fragments once
//   and applies the first sine to them elementwise.
// - A layer of at most 64 columns: 8 n-tiles of accumulators (32
//   registers), epilogue (bias, omega0, sine, the four roundings) on the
//   accumulators in place, and the packed result becomes the next layer's
//   A fragments by renaming registers.
// - A layer wider than 64 (the 256-wide one of every MoTIF SIREN) is made
//   64 columns at a time, and each chunk feeds the next layer's
//   accumulators at once, so 16 x 256 accumulators never exist; when it is
//   the last layer its chunks go straight to out. The layer after a wide
//   one must be at most 64 wide (the wrapper refuses other MLPs).
// - Weights: torch's (out, in) layout is the column-major B operand as it
//   lies. Per layer (N padded to 8, pad16(K) + 8) bfloat16s, zero-filled,
//   then the bias padded to 8; the epilogue reads a bias pair per column
//   pair. Padded k and n contribute zeros (sin(0) = 0).
// Shared memory (weights + 16 warps x slabs), of the 232,448 B a block may
// use, from the pre-activation / whole:
//   STINF 64-64-256-3:       50,960 + 73,728 = 124,688 B / 67-...: 107,408 B
//   SINF  64-64-256-64:      80,640 + 73,728 = 154,368 B / 66-...: 137,088 B
//   synth 64-64-64-256-3:    60,304 + 73,728 = 134,032 B / 198-...: 198,672 B

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "sine.cuh"

#define MAX_LAYERS 8

namespace {

using mma::hi16;
using mma::lo16;
using mma::pack2;
using mma::rnd;

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int M = 16;      // tokens per warp tile
constexpr int CHUNK = 64;  // columns per accumulator pass
constexpr size_t SMEM_LIMIT = 232448;

struct Plan {
  int n_layers;
  int d[MAX_LAYERS + 1];
  int np[MAX_LAYERS];    // d[l + 1] rounded up to 8
  int ld[MAX_LAYERS];    // d[l] rounded up to 16, plus 8: the row stride
  int woff[MAX_LAYERS];  // layer l's (np, ld) weights in params
  int boff[MAX_LAYERS];  // its bias (np)
  int n_params;
  int xs;                // the slab's row stride: d[0] up to 16, plus 8
};

// rows t0 .. t0 + 15 of x (rows past n_tok as zeros) into a slab, 16 bytes
// at a time; K0 % 8 == 0 and x is 16-byte aligned. One commit group.
__device__ __forceinline__ void stage_async(bf16* slab,
                                            const bf16* __restrict__ x,
                                            long long t0, long long n_tok,
                                            int K0, int xs, int lane) {
  const int per_row = K0 >> 3;
  for (int i = lane; i < M * per_row; i += 32) {
    const int row = i / per_row;
    const int c = i - row * per_row;
    const bool in = t0 + row < n_tok;
    const bf16* src = x + (in ? (t0 + row) * K0 + c * 8 : 0);
    const unsigned dst = mma::smem_addr(slab + row * xs + c * 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// the same by 2-byte loads, for any K0: 16 rows' loads in flight at once
__device__ __forceinline__ void stage_plain(bf16* slab,
                                            const bf16* __restrict__ x,
                                            long long t0, long long n_tok,
                                            int K0, int xs, int lane) {
  for (int k = lane; k < K0; k += 32) {
    bf16 v[M];
#pragma unroll
    for (int row = 0; row < M; ++row)
      v[row] = t0 + row < n_tok ? x[(t0 + row) * K0 + k]
                                : __float2bfloat16_rn(0.0f);
#pragma unroll
    for (int row = 0; row < M; ++row) slab[row * xs + k] = v[row];
  }
}

// a = sin(omega0 * a) elementwise on fragments, rounded after omega0 * and
// after the sine
__device__ __forceinline__ void sine_fragments(unsigned (&a)[4][4],
                                               float omega0) {
  float v[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const unsigned u = a[i >> 2][i & 3];
    v[2 * i] = rnd(omega0 * lo16(u));
    v[2 * i + 1] = rnd(omega0 * hi16(u));
  }
  sine::sine_all<true>(v);
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i >> 2][i & 3] = pack2(v[2 * i], v[2 * i + 1]);
}

// The epilogue of `ntiles` n-tiles of accumulators: rounded, plus the
// bias, rounded, and for a sine layer times omega0, rounded, the sine,
// rounded; the result as bfloat16 pairs (pk[j][0] row g, pk[j][1] row
// g + 8). Tiles past ntiles give zeros.
__device__ __forceinline__ void activate(unsigned (&pk)[8][2],
                                         float (&acc)[8][4], const bf16* bias,
                                         int ntiles, float omega0, bool sine,
                                         int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < ntiles) {
      const unsigned bb =
          *reinterpret_cast<const unsigned*>(bias + 8 * j + 2 * t);
      const float b0 = lo16(bb), b1 = hi16(bb);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const unsigned s = pack2(acc[j][2 * p], acc[j][2 * p + 1]);
        const unsigned h = pack2(lo16(s) + b0, hi16(s) + b1);
        if (sine) {
          const unsigned m = pack2(omega0 * lo16(h), omega0 * hi16(h));
          acc[j][2 * p] = lo16(m);
          acc[j][2 * p + 1] = hi16(m);
        } else {
          acc[j][2 * p] = lo16(h);
          acc[j][2 * p + 1] = hi16(h);
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
    }
  }
  if (sine) sine::sine_all<true>(reinterpret_cast<float(&)[32]>(acc));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pk[j][0] = pack2(acc[j][0], acc[j][1]);
    pk[j][1] = pack2(acc[j][2], acc[j][3]);
  }
}

// pk's first ntiles n-tiles into out columns n0.. (< N) of rows t0 + g and
// t0 + g + 8
__device__ __forceinline__ void store_tiles(bf16* __restrict__ out,
                                            long long t0, long long n_tok,
                                            int N, int n0,
                                            const unsigned (&pk)[8][2],
                                            int ntiles, int lane) {
  const int t = lane & 3;
  const bool even = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < ntiles) {
      const int col = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = t0 + (lane >> 2) + 8 * h;
        if (row >= n_tok) continue;
        bf16* o = out + row * N + col;
        if (even) {  // col is even: a 4-byte aligned pair
          if (col < N) *reinterpret_cast<unsigned*>(o) = pk[j][h];
        } else {
          unsigned short* o16 = reinterpret_cast<unsigned short*>(o);
          if (col < N) o16[0] = (unsigned short)(pk[j][h] & 0xffffu);
          if (col + 1 < N) o16[1] = (unsigned short)(pk[j][h] >> 16);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
}

template <bool SKIP>
__global__ void __launch_bounds__(THREADS, 1)
    siren_mlp_bf16_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ params,
                          bf16* __restrict__ out, long long n_tok, Plan plan,
                          float omega0, int sine_last, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const ps = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int L = plan.n_layers;
  const int K0 = plan.d[0];
  const int xs = plan.xs;
  const int slab_elems = M * xs;
  bf16* const slabs = ps + plan.n_params;

  // every layer's weights, once per block; the slabs zeroed, so that their
  // padding columns (never written again) read as zeros
  for (int i = tid; i < plan.n_params / 8; i += THREADS)
    reinterpret_cast<uint4*>(ps)[i] =
        __ldg(reinterpret_cast<const uint4*>(params) + i);
  for (int i = tid; i < WARPS * nbuf * slab_elems / 8; i += THREADS)
    reinterpret_cast<uint4*>(slabs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  bf16* const my = slabs + warp * nbuf * slab_elems;
  const unsigned ps_addr = mma::smem_addr(ps);
  const bool async = nbuf == 2;
  const long long n_tiles = (n_tok + M - 1) / M;
  const long long stride = (long long)gridDim.x * WARPS;
  long long tile = (long long)blockIdx.x * WARPS + warp;
  if (async) {
    if (tile < n_tiles) stage_async(my, x, tile * M, n_tok, K0, xs, lane);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; tile < n_tiles; tile += stride, ++it) {
    const long long t0 = tile * M;
    bf16* const slab = my + (it & (nbuf - 1)) * slab_elems;
    __syncwarp();  // the slab written next was read to its end
    if (async) {
      if (tile + stride < n_tiles)
        stage_async(my + ((it + 1) & 1) * slab_elems, x, (tile + stride) * M,
                    n_tok, K0, xs, lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      stage_plain(slab, x, t0, n_tok, K0, xs, lane);
    }
    __syncwarp();
    const unsigned slab_addr = mma::smem_addr(slab);

    unsigned a[4][4];  // the current activation, up to 64 columns
    float acc[8][4];
    unsigned pk[8][2];
    if (SKIP) {
      const unsigned a_lane = slab_addr + 2 * mma::a_lane_offset(lane, xs);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (16 * ks < K0) {
          mma::ldmatrix_x4(a[ks], a_lane + 32 * ks);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[ks][r] = 0u;
        }
      }
      sine_fragments(a, omega0);
    }
    for (int l = 0; l < L;) {
      const int N = plan.d[l + 1];
      const int NP = plan.np[l];
      const int ld = plan.ld[l];
      const int ksteps = (plan.d[l] + 15) >> 4;
      const unsigned w = ps_addr + 2 * plan.woff[l];
      const bf16* const bias = ps + plan.boff[l];
      const bool last = l == L - 1;
      const bool sine = !last || sine_last;
      const bool from_slab = !SKIP && l == 0;
      if (N <= CHUNK) {
        const int ntiles = NP >> 3;
        zero(acc);
        if (from_slab)
          mma::gemm_smem(acc, slab_addr, xs, ksteps, w, ld, ntiles, lane);
        else
          mma::gemm_regs<4>(acc, a, ksteps, w, ld, ntiles, lane);
        activate(pk, acc, bias, ntiles, omega0, sine, lane);
        if (last)
          store_tiles(out, t0, n_tok, N, 0, pk, ntiles, lane);
        else
          mma::frag_from_packed(a, pk);
        l += 1;
      } else {
        // a wide layer, 64 columns at a time; each chunk feeds layer
        // l + 1's accumulators, or goes to out when the wide layer is last
        const int l2 = last ? l : l + 1;
        const int ntiles2 = plan.np[l2] >> 3;
        const int ld2 = plan.ld[l2];
        const unsigned w2 = ps_addr + 2 * plan.woff[l2];
        float acc2[8][4];
        zero(acc2);
        for (int n0 = 0; n0 < NP; n0 += CHUNK) {
          const int nt = min(8, (NP - n0) >> 3);
          const unsigned wc = w + 2 * n0 * ld;
          zero(acc);
          if (from_slab)
            mma::gemm_smem(acc, slab_addr, xs, ksteps, wc, ld, nt, lane);
          else
            mma::gemm_regs<4>(acc, a, ksteps, wc, ld, nt, lane);
          activate(pk, acc, bias + n0, nt, omega0, sine, lane);
          if (last) {
            store_tiles(out, t0, n_tok, N, n0, pk, nt, lane);
          } else {
            unsigned ac[4][4];
            mma::frag_from_packed(ac, pk);
            mma::gemm_regs<4>(acc2, ac, (nt + 1) >> 1, w2 + 2 * n0, ld2,
                              ntiles2, lane);
          }
        }
        if (last) {
          l += 1;
        } else {
          const bool last2 = l2 == L - 1;
          activate(pk, acc2, ps + plan.boff[l2], ntiles2, omega0,
                   !last2 || sine_last, lane);
          if (last2)
            store_tiles(out, t0, n_tok, plan.d[l2 + 1], 0, pk, ntiles2, lane);
          else
            mma::frag_from_packed(a, pk);
          l += 2;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool SKIP>
int launch(const void* x, const void* params, void* out, long long n_tok,
           const Plan& p, int n_sm, float omega0, int sine_last, int nbuf,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * ((size_t)p.n_params + (size_t)WARPS * nbuf * M * p.xs);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      siren_mlp_bf16_kernel<SKIP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tok > 0) {
    const long long blocks = ((n_tok + M - 1) / M + WARPS - 1) / WARPS;
    const unsigned grid = (unsigned)(blocks < n_sm ? blocks : n_sm);
    siren_mlp_bf16_kernel<SKIP><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(params),
        static_cast<bf16*>(out), n_tok, p, omega0, sine_last, nbuf);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_tok, dims[0]), params as packed by the wrapper and out
// (n_tok, dims[n_layers]) are bfloat16. skip_first: x is the first layer's
// pre-activation (dims[0] <= 64 wide) and params hold the layers after it.
// nbuf: 2 slabs per warp filled by cp.async (dims[0] % 8 == 0 and x 16-byte
// aligned), or 1 filled by 2-byte loads.
extern "C" int siren_mlp_bf16_forward(const void* x, const void* params,
                                      void* out, long long n_tok,
                                      const int* dims, int n_layers, int n_sm,
                                      float omega0, int sine_last,
                                      int skip_first, int nbuf, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || (nbuf != 1 && nbuf != 2) ||
      (skip_first && dims[0] > CHUNK))
    return (int)cudaErrorInvalidValue;
  if (nbuf == 2 && (dims[0] % 8 != 0 || (unsigned long long)x % 16 != 0))
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.n_layers = n_layers;
  int off = 0;
  for (int l = 0; l <= n_layers; ++l) p.d[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    // a layer wider than 64 must be last or feed one of at most 64
    if (dims[l + 1] > CHUNK && l + 1 < n_layers && dims[l + 2] > CHUNK)
      return (int)cudaErrorInvalidValue;
    p.np[l] = (dims[l + 1] + 7) & ~7;
    p.ld[l] = ((dims[l] + 15) & ~15) + 8;
    p.woff[l] = off;
    p.boff[l] = off + p.np[l] * p.ld[l];
    off = p.boff[l] + p.np[l];
  }
  p.n_params = off;
  p.xs = p.ld[0];
  const cudaStream_t s = (cudaStream_t)stream;
  if (skip_first)
    return launch<true>(x, params, out, n_tok, p, n_sm, omega0, sine_last,
                        nbuf, s);
  return launch<false>(x, params, out, n_tok, p, n_sm, omega0, sine_last,
                       nbuf, s);
}
