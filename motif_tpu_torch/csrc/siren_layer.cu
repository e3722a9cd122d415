// siren_layer: ONE float32 SIREN layer that runs alone,
//   y = [sin(omega0 *)](x W^T + b),
// optionally from sin(omega0 * x) (the first layer of a skip-first MLP).
//
// Replaces, with csrc/siren_mlp.cu, the TPU kernel
// motif_tpu/ops/siren_kernel.py::_kernel (behind siren_fused). siren_mlp.cu
// keeps a whole MLP's weights resident in a block's shared memory, as the
// TPU kernel keeps them in VMEM. An MLP too large for that is cut by the
// wrapper (siren_kernel.segments) into runs of that kernel and single
// layers, and a single layer runs here, whatever its K and N: VideoINR's
// 201 / 463 / 525 / 1049 -> 64 first layers, its 256 -> 256 and 256 -> 3,
// setting 6's 331 -> 64.
//
// Bound on an H100: a layer of K inputs and N outputs over n tokens does
// 2 K N n flops against 4 (K + N) n bytes, K N / (2 (K + N)) flops a byte
// against the card's fp32 balance of 67e12 / 3.35e12 = 20: 1049 -> 64 is at
// 30 (operations), 256 -> 256 at 64 (operations), 256 -> 3 at 1.5 (bytes).
//
// Design:
// - A streamed-weight GEMM with a fused epilogue (N >= NARROW): blocks
//   over BM tokens x BN columns, (BM, BN) = (128, 64) with 128 threads for
//   N <= 64 and (128, 128) with 256 above, the grid over (token tile,
//   column tile) with a token tile's column tiles next to each other, so a
//   256 -> 256 layer is one launch whose blocks share x through L2 and x
//   is read from HBM once. K goes in tiles of BK = 16 through a ring of
//   STAGES = 4 stages in shared memory, filled by cp.async while the block
//   computes on the stages before: 56 KB a block for N <= 64 (three blocks
//   an SM, at most 168 registers a thread), 72 KB above (two, 128).
// - x rows are K elements apart (VideoINR's concatenations are odd-wide, so
//   rows are only 4-byte aligned) or ldx apart: x is staged with 4-byte
//   cp.async copies, a warp's 32 copies on 32 / KW rows x KW consecutive k
//   (coalesced row segments; the blocks of a full token tile and whole K
//   tiles copy without bounds checks), transposed into k-major rows of
//   BM + 32 floats in which the tokens are shifted by 4 (k % 8): the float4
//   reads below are free of bank conflicts, and a thread's reads are one
//   base register plus constant offsets. W^T (K, NP) rows are 16-byte
//   aligned: 16-byte copies.
// - Register tile 8 tokens x 8 columns a thread, as two float4 of tokens
//   BM / 2 apart and two of columns BN / 2 apart, a warp 4 x 8 threads,
//   so that a warp's four shared-memory reads a k are each one wavefront:
//   4 reads for 64 FMAs.
// - N < NARROW (the 3- and 4-wide outputs, bound by bytes): a dot-product
//   variant, one thread a token over all N outputs, x streamed through the
//   same kind of ring in tiles of 128 tokens x 32 k (a warp copies 32
//   consecutive k of one row), swizzled so that a thread's reads down its
//   token's k are conflict-free; the W^T tile is read by every thread as
//   broadcast float4s.
// - Order of the sums: every output is one chain of fp32 FMAs in
//   ascending k from 0, then + bias, no split-K and no zero terms (the last
//   K tile runs only its k): the order of cuBLAS's fp32 GEMM, so a launch
//   is bit-equal to F.linear (+ sin). No TF32, no tensor cores. The sine
//   is sin_rr (sine.cuh): sinf bit for bit, branch-free; the motion SIRENs'
//   outputs place splat pixels by floor().
//
// Layout (float32):
//   x       (n_tok, K) in rows ldx >= K elements apart
//   params  W^T zero-padded to (K, NP), NP = N rounded up to 8, then the
//           bias zero-padded to NP (one layer of siren_mlp.cu's layout);
//           16-byte aligned
//   out     (n_tok, N) in rows ldo >= N elements apart (a wider activation)

#include <cuda_runtime.h>

#include <cstdint>

#include "sine.cuh"

namespace {

constexpr int NARROW = 16;    // N below this: the dot-product variant
constexpr int NT = 128;       // the dot products' tokens (= threads) a block
constexpr int NBK = 32;       // their k a stage
constexpr int NSTAGES = 3;    // their ring

struct Layer {
  const float* x;
  const float* w;  // W^T (K, np)
  const float* b;  // (np)
  float* out;
  long long ldx;
  long long ldo;
  long long n_tok;
  int K;
  int N;
  int np;
  int vec_out;  // out 16-byte aligned and ldo % 4 == 0: float4 stores
  int sine;     // sin(omega0 * .) after the bias
  float omega0;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4 bytes, zero-filled where !in (the source is not read then)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// 4 bytes, the source in range
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// 16 bytes, zero-filled where !in
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// v = sin(omega0 * v), each product rounded, as torch.sin(omega0 * x)
template <int N>
__device__ __forceinline__ void omega_sine(float (&v)[N], float omega0) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __fmul_rn(omega0, v[i]);
  sine::sine_all<true>(v);
}

// ---------------------------------------------------------------------------
// The GEMM (N >= NARROW)
// ---------------------------------------------------------------------------

// A GEMM configuration: BM tokens x BN columns a block, 8 x 8 outputs a
// thread (so (BM / 8) (BN / 8) threads), K in tiles of BK through a ring
// of STAGES, a warp's x copies on 32 / KW rows x KW consecutive k, at
// least MINB blocks an SM.
template <int BM_, int BN_, int BK_, int STAGES_, int KW_, int MINB_>
struct Gemm {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int KW = KW_, MINB = MINB_;
  static constexpr int NTH = BN / 8;   // threads along the columns
  static constexpr int WN = NTH / 8;   // warps along the columns
  static constexpr int THREADS = (BM / 8) * NTH;
  static constexpr int RS = THREADS / KW;  // rows apart of a thread's copies
  static constexpr int XLD = BM + 32;  // a k row of x: BM tokens, shifted
  static constexpr int XS = BK * XLD;  // floats of x a stage
  static constexpr int WS = BK * BN;   // floats of W^T a stage
  static constexpr int XCP = BM * BK / THREADS;      // x copies a thread
  static constexpr int WCP = BK * BN / 4 / THREADS;  // W^T copies a thread
  static constexpr size_t SMEM = sizeof(float) * STAGES * (XS + WS);
  static_assert(BM % 32 == 0 && NTH % 8 == 0 && WCP >= 1 &&
                    BK * BN / 4 % THREADS == 0,
                "tile shape");
  static_assert(BK % KW == 0 && BM % RS == 0 && KW % 8 == 0, "x copies");

  // where x element (token r, k) of a stage lies: k-major rows of XLD, the
  // token shifted by 4 (k % 8), so that the float4 reads (consecutive
  // tokens a warp) are free of bank conflicts and a warp's copies hit
  // 32 / KW x 8 banks (2-way conflicts for KW = 16)
  static __device__ __forceinline__ int xpos(int r, int k) {
    return k * XLD + r + 4 * (k & 7);
  }
};

// The two the wrapper takes, chosen on the card
// (tools/siren_layer_variants.py) among BM 64 / 128 / 256, BK 16 / 32,
// STAGES 2 - 5, KW 8 / 16 / 32 and MINB 1 - 6 at 1049 / 525 / 463 / 331 /
// 201 -> 64 and 256 -> 256 (and 8 x 16 outputs a thread, slower).
using GemmNarrowN = Gemm<128, 64, 16, 4, 16, 3>;  // 16 <= N <= 64
using GemmWideN = Gemm<128, 128, 16, 4, 8, 2>;    // N > 64

// Stage K tile [k0, k0 + BK) of the block's tokens and columns: thread
// (r0, kk) copies x(t0 + r0 + RS j, k0 + KW h + kk) for each j, h. CHECK:
// tokens past n_tok or k past K are zero-filled (the last token tile, the
// last K tile); else every copy is in range.
template <class G, bool CHECK>
__device__ __forceinline__ void gemm_stage(float* xs, float* ws,
                                           const Layer& p, long long t0,
                                           int n0, int k0) {
  const int tid = threadIdx.x;
  const int kk = tid % G::KW;
  const int r0 = tid / G::KW;
  const float* const x0 = p.x + (t0 + r0) * p.ldx + k0 + kk;
#pragma unroll
  for (int i = 0; i < G::XCP; ++i) {
    const int j = (G::RS * i) % G::BM;
    const int h = ((G::RS * i) / G::BM) * G::KW;
    float* const dst = xs + G::xpos(r0 + j, h + kk);
    if (CHECK) {
      const bool in = t0 + r0 + j < p.n_tok && k0 + h + kk < p.K;
      cp4(dst, in ? x0 + j * p.ldx + h : p.x, in);
    } else {
      cp4(dst, x0 + j * p.ldx + h);
    }
  }
#pragma unroll
  for (int i = 0; i < G::WCP; ++i) {
    const int e = tid + G::THREADS * i;
    const int k = e / (G::BN / 4);
    const int c = (e % (G::BN / 4)) * 4;
    const bool in = k0 + k < p.K && n0 + c < p.np;
    const float* src = in ? p.w + (long long)(k0 + k) * p.np + n0 + c : p.w;
    cp16(ws + k * G::BN + c, src, in);
  }
}

// The skip-first input: sin(omega0 * x) over the elements this thread
// staged (its copies have landed: after its wait_group), in place.
template <class G>
__device__ __forceinline__ void gemm_in_sine(float* xs, float omega0) {
  const int kk = threadIdx.x % G::KW;
  const int r0 = threadIdx.x / G::KW;
  float v[G::XCP];
#pragma unroll
  for (int i = 0; i < G::XCP; ++i)
    v[i] = xs[G::xpos(r0 + (G::RS * i) % G::BM,
                      ((G::RS * i) / G::BM) * G::KW + kk)];
  omega_sine(v, omega0);
#pragma unroll
  for (int i = 0; i < G::XCP; ++i)
    xs[G::xpos(r0 + (G::RS * i) % G::BM,
               ((G::RS * i) / G::BM) * G::KW + kk)] = v[i];
}

// acc[i][j] += x(k, token i) * w(k, column j) for one k of a stage; xt
// and wt point at this thread's tokens and columns at k = 0
template <class G>
__device__ __forceinline__ void gemm_k(float (&acc)[8][8], const float* xt,
                                       const float* wt, int k) {
  const float* xr = xt + G::xpos(0, k);
  const float* wr = wt + k * G::BN;
  const float4 a0 = lds4(xr), a1 = lds4(xr + G::BM / 2);
  const float4 b0 = lds4(wr), b1 = lds4(wr + G::BN / 2);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
}

template <class G, bool IN_SINE>
__global__ void __launch_bounds__(G::THREADS, G::MINB)
    gemm_kernel(Layer p) {
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK, STAGES = G::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;                      // [STAGES][BK][XLD]
  float* const ws = smem + STAGES * G::XS;     // [STAGES][BK][BN]
  const int n_ct = (p.N + BN - 1) / BN;
  const long long t0 = (long long)(blockIdx.x / n_ct) * BM;
  const int n0 = (blockIdx.x % n_ct) * BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this thread's tokens: 4 tm + {0..3} and BM / 2 + 4 tm + {0..3};
  // columns 4 tn + {0..3} and BN / 2 + 4 tn + {0..3}; a warp is 4 x 8
  const int tm = (warp / G::WN) * 4 + (lane >> 3);
  const int tn = (warp % G::WN) * 8 + (lane & 7);
  const int KT = (p.K + BK - 1) / BK;
  // the block's tokens all exist: only the last K tile is checked
  const int kt_whole = t0 + BM <= p.n_tok ? p.K / BK : 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_whole)
      gemm_stage<G, false>(xs + s * G::XS, ws + s * G::WS, p, t0, n0,
                           s * BK);
    else if (s < KT)
      gemm_stage<G, true>(xs + s * G::XS, ws + s * G::WS, p, t0, n0,
                          s * BK);
    commit();
  }
  float acc[8][8] = {};
  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % STAGES;
    wait_group<STAGES - 2>();
    if (IN_SINE) gemm_in_sine<G>(xs + slot * G::XS, p.omega0);
    __syncthreads();  // stage kt is in; stage kt - 1 is consumed
    const int nk = kt + STAGES - 1;
    float* const xn = xs + (nk % STAGES) * G::XS;
    float* const wn = ws + (nk % STAGES) * G::WS;
    if (nk < kt_whole)
      gemm_stage<G, false>(xn, wn, p, t0, n0, nk * BK);
    else if (nk < KT)
      gemm_stage<G, true>(xn, wn, p, t0, n0, nk * BK);
    commit();
    const float* xt = xs + slot * G::XS + 4 * tm;
    const float* wt = ws + slot * G::WS + 4 * tn;
    const int kn = min(BK, p.K - kt * BK);
    if (kn == BK) {
#pragma unroll
      for (int k = 0; k < BK; ++k) gemm_k<G>(acc, xt, wt, k);
    } else {
      for (int k = 0; k < kn; ++k) gemm_k<G>(acc, xt, wt, k);
    }
  }
  wait_group<0>();

  // epilogue, a token at a time: + bias, sin(omega0 *), stored from
  // registers
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + (j < 4 ? 0 : BN / 2) + tn * 4 + (j & 3);
    bias[j] = c < p.N ? __ldg(p.b + c) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fadd_rn(acc[i][j], bias[j]);
    if (p.sine) omega_sine(acc[i], p.omega0);
    const long long t = t0 + (i < 4 ? 0 : BM / 2) + tm * 4 + (i & 3);
    if (t >= p.n_tok) continue;
    float* const o = p.out + t * p.ldo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * (BN / 2) + tn * 4;
      if (p.vec_out && c + 4 <= p.N) {
        *reinterpret_cast<float4*>(o + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < p.N) o[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The dot products (N < NARROW): thread t of a block owns token t0 + t and
// outputs 0 .. 4 NV - 1 (the padded ones are zero weights, not stored).
// ---------------------------------------------------------------------------

template <int NV>
struct Narrow {
  static constexpr int XS = NBK * NT;      // floats of x a stage
  static constexpr int WS = NBK * 4 * NV;  // floats of W^T a stage
  static constexpr int XCP = XS / NT;      // x copies a thread (32)
  static constexpr size_t SMEM = sizeof(float) * NSTAGES * (XS + WS);
  static_assert(NBK == 32 && NT % 32 == 0, "a warp copies 32 k of a row");
};

// x element (row r, k) goes to xs[k][r ^ k]: warp w copies rows w, w + 4,
// ... one row of 32 consecutive k at a time
template <int NV>
__device__ __forceinline__ void narrow_stage(float* xs, float* ws,
                                             const Layer& p, long long t0,
                                             int k0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool kin = k0 + lane < p.K;
#pragma unroll 8
  for (int i = 0; i < Narrow<NV>::XCP; ++i) {
    const int r = warp + (NT / 32) * i;
    const bool in = kin && t0 + r < p.n_tok;
    const float* src = in ? p.x + (t0 + r) * p.ldx + k0 + lane : p.x;
    cp4(xs + lane * NT + (r ^ lane), src, in);
  }
  if (threadIdx.x < NBK * NV) {
    const int k = threadIdx.x / NV;
    const int c = (threadIdx.x % NV) * 4;
    const bool in = k0 + k < p.K;
    const float* src = in ? p.w + (long long)(k0 + k) * p.np + c : p.w;
    cp16(ws + k * 4 * NV + c, src, in);
  }
}

template <int NV>
__device__ __forceinline__ void narrow_in_sine(float* xs, float omega0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[Narrow<NV>::XCP];
#pragma unroll
  for (int i = 0; i < Narrow<NV>::XCP; ++i) {
    const int r = warp + (NT / 32) * i;
    v[i] = xs[lane * NT + (r ^ lane)];
  }
  omega_sine(v, omega0);
#pragma unroll
  for (int i = 0; i < Narrow<NV>::XCP; ++i) {
    const int r = warp + (NT / 32) * i;
    xs[lane * NT + (r ^ lane)] = v[i];
  }
}

template <int NV>
__device__ __forceinline__ void narrow_k(float (&acc)[4 * NV], const float* xs,
                                         const float* ws, int k, int t) {
  const float a = xs[k * NT + (t ^ k)];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 w = lds4(ws + k * 4 * NV + 4 * v);
    acc[4 * v] = __fmaf_rn(a, w.x, acc[4 * v]);
    acc[4 * v + 1] = __fmaf_rn(a, w.y, acc[4 * v + 1]);
    acc[4 * v + 2] = __fmaf_rn(a, w.z, acc[4 * v + 2]);
    acc[4 * v + 3] = __fmaf_rn(a, w.w, acc[4 * v + 3]);
  }
}

template <int NV, bool IN_SINE>
__global__ void __launch_bounds__(NT) narrow_kernel(Layer p) {
  using G = Narrow<NV>;
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;                     // [NSTAGES][NBK][NT]
  float* const ws = smem + NSTAGES * G::XS;   // [NSTAGES][NBK][4 NV]
  const long long t0 = (long long)blockIdx.x * NT;
  const int t = threadIdx.x;
  const int KT = (p.K + NBK - 1) / NBK;

#pragma unroll
  for (int s = 0; s < NSTAGES - 1; ++s) {
    if (s < KT)
      narrow_stage<NV>(xs + s * G::XS, ws + s * G::WS, p, t0, s * NBK);
    commit();
  }
  float acc[4 * NV] = {};
  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % NSTAGES;
    wait_group<NSTAGES - 2>();
    if (IN_SINE) narrow_in_sine<NV>(xs + slot * G::XS, p.omega0);
    __syncthreads();
    const int nk = kt + NSTAGES - 1;
    if (nk < KT)
      narrow_stage<NV>(xs + (nk % NSTAGES) * G::XS,
                       ws + (nk % NSTAGES) * G::WS, p, t0, nk * NBK);
    commit();
    const float* x_s = xs + slot * G::XS;
    const float* w_s = ws + slot * G::WS;
    const int kn = min(NBK, p.K - kt * NBK);
    if (kn == NBK) {
#pragma unroll
      for (int k = 0; k < NBK; ++k) narrow_k<NV>(acc, x_s, w_s, k, t);
    } else {
      for (int k = 0; k < kn; ++k) narrow_k<NV>(acc, x_s, w_s, k, t);
    }
  }
  wait_group<0>();

#pragma unroll
  for (int n = 0; n < 4 * NV; ++n)
    acc[n] = __fadd_rn(acc[n], n < p.N ? __ldg(p.b + n) : 0.0f);
  if (p.sine) omega_sine(acc, p.omega0);
  if (t0 + t >= p.n_tok) return;
  float* const o = p.out + (t0 + t) * p.ldo;
#pragma unroll
  for (int n = 0; n < 4 * NV; ++n)
    if (n < p.N) o[n] = acc[n];
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, long long blocks, int threads,
           const Layer& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class G>
int launch_gemm(const Layer& p, int in_sine, cudaStream_t stream) {
  const long long blocks =
      (p.n_tok + G::BM - 1) / G::BM * ((p.N + G::BN - 1) / G::BN);
  return in_sine ? launch(gemm_kernel<G, true>, G::SMEM, blocks, G::THREADS,
                          p, stream)
                 : launch(gemm_kernel<G, false>, G::SMEM, blocks,
                          G::THREADS, p, stream);
}

template <int NV>
int launch_narrow(const Layer& p, int in_sine, cudaStream_t stream) {
  using G = Narrow<NV>;
  const long long blocks = (p.n_tok + NT - 1) / NT;
  return in_sine ? launch(narrow_kernel<NV, true>, G::SMEM, blocks, NT, p,
                          stream)
                 : launch(narrow_kernel<NV, false>, G::SMEM, blocks, NT, p,
                          stream);
}

}  // namespace

// One layer over n_tok tokens. params: W^T (K, NP) then the bias (NP),
// NP = N rounded up to 8, 16-byte aligned. sine: sin(omega0 * .) after the
// bias; in_sine: sin(omega0 * x) first (a skip-first MLP's first layer).
extern "C" int siren_layer_forward(const void* x, long long ldx,
                                   const void* params, void* out,
                                   long long ldo, long long n_tok, int K,
                                   int N, float omega0, int sine, int in_sine,
                                   void* stream) {
  Layer p;
  p.x = static_cast<const float*>(x);
  p.np = (N + 7) & ~7;
  p.w = static_cast<const float*>(params);
  p.b = p.w + (long long)K * p.np;
  p.out = static_cast<float*>(out);
  p.ldx = ldx;
  p.ldo = ldo;
  p.n_tok = n_tok;
  p.K = K;
  p.N = N;
  p.vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && ldo % 4 == 0;
  p.sine = sine;
  p.omega0 = omega0;
  if (K < 1 || N < 1 || ldx < K || ldo < N || n_tok < 0 ||
      reinterpret_cast<uintptr_t>(params) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < NARROW) {
    switch ((N + 3) / 4) {
      case 1: return launch_narrow<1>(p, in_sine, s);
      case 2: return launch_narrow<2>(p, in_sine, s);
      case 3: return launch_narrow<3>(p, in_sine, s);
      default: return launch_narrow<4>(p, in_sine, s);
    }
  }
  if (N <= 64) return launch_gemm<GemmNarrowN>(p, in_sine, s);
  return launch_gemm<GemmWideN>(p, in_sine, s);
}
