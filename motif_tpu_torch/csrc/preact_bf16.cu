// preact_bf16: the first-layer pre-activations of MoTIF's fused decode, each
// written in one pass from its parts; a bfloat16 entry (the serving knobs)
// and a float32 one per site.
//
// Replaces no TPU kernel. Under `fused_decode` each SIREN's first layer is
// folded through the LIIF nearest takes, so the products with K >= 64 run at
// low resolution (or, for the payload's q_feat_o, stay one cuBLAS product)
// and the pieces are put back together at high resolution. On the TPU XLA
// fused that assembly into its neighbours; as plain PyTorch it is some twenty
// passes over (rows, HH, WW, 64) tensors (takes, repeats, K = 2 / 3 products,
// broadcast adds, casts), each reading and writing the whole tensor. Here
// each site is one kernel that reads each part once and writes the result
// once, in the dtype the plain version (`ops/preact.py::preact_plain`)
// returns. Four sites (motif.py's MoTIF.head), in bfloat16 compute:
//
//   stinf    h0 = rep(take(lr)) + t*w_t + rel @ W_rel + b        bf16 out
//   sinf     g0 = take(lr) + rel @ W_rel + b                      bf16 out
//   payload  feat_hr = f32(rep(dense + take(lr))) + flow @ W_flow f32 out
//   synth    h = bf16(dense) + bf16(extra) @ W_e + take(lr) + t*w_t + b
//
// and the same sums with every tensor float32 in float32 compute.
// take(lr)[r, y, x, c] = lr[r / rep, iy[y], ix[x], c]: the nearest LR cell
// of each HR pixel, from the bucket's take tables; `rep` (the number of
// times N, or 1) stands for the plain version's repeat_interleave, so row r
// reads row r / rep of the LR table and of `dense`: index arithmetic, no
// copy. `hr` is the K <= 3 channels of an HR tensor read in its own type at
// `hr + r * hr_row + pixel * hr_pix` (hr_row 0: one row for all, as `rel`).
// The weights are read from the (64, fan_in) first-layer matrix as it is
// stored, columns col_hr .. col_hr + K - 1 and col_t; t is one value a row.
//
// Numerics: bit for bit the plain version's. Each PyTorch bfloat16 op
// computes in float32 and rounds once to bfloat16 (nearest even); the kernel
// rounds each term and each partial sum where the plain version does, in
// its order. The K-term products are cuBLAS's: the float32 ones its SGEMM's
// FMA chain, acc = fma(a_k, w_k, acc) from acc = 0, k ascending; the
// bfloat16 ones (rel, the extras) as its tensor cores sum them
// (`tensor_core_dot`). That chain, rounded to nearest, would leave 1-8 of
// ~2e7 elements of `sinf` and `synth` apart at the serving shapes, and 2e-5
// of `synth`'s where the extras span many binades, each by one bfloat16 ulp
// of a partial sum (up to 0.0625 at the synthesis' magnitudes).
//
// Bound on an H100: memory. At the serving chunk (two anchors, one clip,
// three times, 256 x 448, 64 channels) the four launches write 88 + 29 +
// 176 + 44 MB and read 29 MB (the payload's dense term) + 88 MB (the synth's
// float32 splat output) + a few MB of LR tables and HR channels, which stay
// in L2: ~460 MB, 0.14 ms at 3.35 TB/s. The arithmetic is a few dozen
// instructions an element (the roundings, and the tensor cores' sum done in
// integers), which the sites' measured 34-60% of that bound reflect.
//
// Design: a thread computes 8 channels of one pixel (one 16-byte store of
// bfloat16, two of float32), so the 8 threads of a pixel write its 64
// channels as one contiguous run and read the LR table's matching run (a
// 128- or 256-byte line that neighbouring HR pixels share, in L1). The grid
// is one wave, four blocks a multiprocessor (64 registers a thread), and
// each thread strides over the items by the whole grid, a multiple of 8, so
// its channels never change. Where every row reads one HR row (`rel`) a
// thread forms the HR term once and writes it into each row's pixel (STINF:
// the n * N rows). A block reads the weights once, into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int C = 64;     // channels of every pre-activation
constexpr int VEC = 8;    // channels a thread
constexpr int KMAX = 3;   // HR channels at most (the synth's extras)
typedef __nv_bfloat16 bf16;

enum Site { STINF = 0, SINF = 1, PAYLOAD = 2, SYNTH = 3 };

// v rounded to the compute type T, as a PyTorch op of that type returns it
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// VEC consecutive values at p (16-byte aligned) as floats
__device__ __forceinline__ void load8(const bf16* p, float (&v)[VEC]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the values are already rounded where the output is bfloat16: exact
__device__ __forceinline__ void store8(bf16* p, const float (&v)[VEC]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

constexpr int NO_EXPONENT = -30000;   // of 0: below any product's

// floor(log2 |v|), NO_EXPONENT for 0 (the exponent field where v is normal)
__device__ __forceinline__ int exponent(float v) {
  const int f = (__float_as_int(v) >> 23) & 0xff;
  if (f != 0) return f - 127;
  return v != 0.0f ? ilogbf(v) : NO_EXPONENT;
}

// 2^n for -126 <= n <= 127
__device__ __forceinline__ float pow2(int n) {
  return __int_as_float((n + 127) << 23);
}

// sum_k p[k] cut as `tensor_core_dot` does, where 2^(e - 25) or 2^(25 - e)
// is no normal float (far from the serving path's magnitudes)
__device__ __noinline__ float cut_sum_far(float p0, float p1, float p2,
                                          int e) {
  const int s = (int)ldexpf(p0, 25 - e) + (int)ldexpf(p1, 25 - e) +
                (int)ldexpf(p2, 25 - e);
  return ldexpf(__int2float_rz(s), e - 25);
}

// cuBLAS's bfloat16 matrix product at K <= 3 (products of bfloat16 values,
// float32 sums) on the H100's tensor cores, term k = h[k] * w[k][c]: every
// product is exact; each is cut toward zero to a multiple of 2^(E - 25), E
// the largest sum of its two factors' exponents; the cut products are summed
// exactly and the sum cut toward zero to float32. (Measured against cuBLAS:
// equal on 22M sums of two and of three terms spread over many binades; a
// float32 sum in ascending k, rounded to nearest, differed in ~7e-5 of
// them, where the exact sum needs more than 24 bits.) In units of
// 2^(E - 25) a cut product is an integer below 2^27 in magnitude, so three
// of them sum exactly in 32 bits. `ew` holds the weights' exponents.
__device__ __forceinline__ float tensor_core_dot(
    const float (&h)[KMAX], const int (&eh)[KMAX], const float (&w)[KMAX][C],
    const int (&ew)[KMAX][C], int c, int K) {
  float p[KMAX];
  int e = 2 * NO_EXPONENT;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    p[k] = k < K ? __fmul_rn(h[k], w[k][c]) : 0.0f;
    if (k < K) e = max(e, eh[k] + ew[k][c]);
  }
  if (e < NO_EXPONENT / 2) return 0.0f;  // every product has a zero factor
  if (e < -101 || e > 102) return cut_sum_far(p[0], p[1], p[2], e);
  const float up = pow2(25 - e);
  int s = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) s += (int)__fmul_rn(p[k], up);
  return __fmul_rn(__int2float_rz(s), pow2(e - 25));
}

// the element types of each site: the compute type L (the LR table, t and
// the bias), dense term D, HR channels HR, weights WT, output O; in float32
// compute all are float
template <int SITE, bool F32> struct Types;
template <int SITE> struct Types<SITE, true> {
  typedef float L, D, HR, WT, O;
};
template <> struct Types<STINF, false> { typedef bf16 L, D, HR, WT, O; };
template <> struct Types<SINF, false> { typedef bf16 L, D, HR, WT, O; };
template <> struct Types<PAYLOAD, false> {
  typedef bf16 L, D;
  typedef float HR, WT, O;
};
template <> struct Types<SYNTH, false> {
  typedef bf16 L, WT, O;
  typedef float D, HR;
};

struct Args {
  const void* lr;          // (rows / rep, H, W, C)
  const long long* iy;     // (HH,) rows of the LR table
  const long long* ix;     // (WW,) columns
  const void* dense;       // (rows / rep, HH, WW, C) or null
  const void* hr;          // K channels a pixel, strided
  long long hr_row;        // elements between rows (0: one row for all)
  int hr_pix;              // elements between pixels
  int K;
  const void* w;           // (C, w_ld) first-layer weight as stored
  int w_ld, col_hr, col_t;
  const void* t;           // (rows,) or null
  const void* bias;        // (C,) or null
  void* out;               // (rows, HH, WW, C)
  int H, W, HH, WW, rep;
  int inner;               // rows that share one HR row (all where hr_row 0)
  int n_items;             // (rows / inner) * HH * WW * C / VEC
};

template <int SITE, bool F32>
__global__ void __launch_bounds__(THREADS, 4)
preact_kernel(const Args a) {
  typedef typename Types<SITE, F32>::L L;
  typedef typename Types<SITE, F32>::D D;
  typedef typename Types<SITE, F32>::HR HR;
  typedef typename Types<SITE, F32>::WT WT;
  typedef typename Types<SITE, F32>::O O;
  // the weights, once a block: K columns of the HR term (and their
  // exponents), the time's column, the bias
  __shared__ float sw[KMAX][C], st[C], sb[C];
  __shared__ int se[KMAX][C];
  const WT* w = static_cast<const WT*>(a.w);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const WT* row = w + (long long)c * a.w_ld;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      sw[k][c] = k < a.K ? ld(row + a.col_hr + k) : 0.0f;
      se[k][c] = exponent(sw[k][c]);
    }
    st[c] = (SITE == STINF || SITE == SYNTH) ? ld(row + a.col_t) : 0.0f;
    sb[c] = SITE == PAYLOAD ? 0.0f : ld(static_cast<const L*>(a.bias) + c);
  }
  __syncthreads();
  const int stride = gridDim.x * THREADS;   // a multiple of C / VEC
  int j = blockIdx.x * THREADS + threadIdx.x;
  const int c0 = (j % (C / VEC)) * VEC;     // the same on every iteration
  const L* lr = static_cast<const L*>(a.lr);
  const L* t = static_cast<const L*>(a.t);
  const HR* hr = static_cast<const HR*>(a.hr);
  const D* dense = static_cast<const D*>(a.dense);
  O* out = static_cast<O*>(a.out);
  const int hw = a.HH * a.WW;

  for (; j < a.n_items; j += stride) {
    const int pix = j / (C / VEC);
    const int g = pix / hw;       // rows g * inner .. share this HR term
    const int p = pix - g * hw;
    const int y = p / a.WW;
    const int x = p - y * a.WW;
    const long long at = ((long long)a.iy[y] * a.W + a.ix[x]) * C + c0;
    // the HR term: K channels (the synth's extras cast to the compute type
    // first) times the weights, as cuBLAS sums them
    float h[KMAX];
    int eh[KMAX];
    const HR* hp = hr + (long long)g * a.hr_row + (long long)p * a.hr_pix;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      h[k] = k < a.K ? ld(hp + k) : 0.0f;
      if (SITE == SYNTH) h[k] = rnd<L>(h[k]);
      eh[k] = exponent(h[k]);
    }
    float kt[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (F32 || SITE == PAYLOAD) {   // float32 products: SGEMM
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < a.K) acc = __fmaf_rn(h[k], sw[k][c0 + i], acc);
        kt[i] = acc;
      } else {                                  // bfloat16: tensor cores
        kt[i] = tensor_core_dot(h, eh, sw, se, c0 + i, a.K);
      }
    }
    for (int r = g * a.inner; r < (g + 1) * a.inner; ++r) {
      const int rs = r / a.rep;
      float v[VEC], l[VEC];
      load8(lr + (long long)rs * a.H * a.W * C + at, l);
      const float tr = (SITE == STINF || SITE == SYNTH) ? ld(t + r) : 0.0f;
      if constexpr (SITE == STINF) {    // ((take + t*w_t) + rel @ W) + b
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float s = rnd<L>(__fadd_rn(l[i], rnd<L>(__fmul_rn(tr, st[c0 + i]))));
          s = rnd<L>(__fadd_rn(s, rnd<L>(kt[i])));
          v[i] = rnd<L>(__fadd_rn(s, sb[c0 + i]));
        }
      } else if constexpr (SITE == SINF) {  // (take + rel @ W) + b
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float s = rnd<L>(__fadd_rn(l[i], rnd<L>(kt[i])));
          v[i] = rnd<L>(__fadd_rn(s, sb[c0 + i]));
        }
      } else if constexpr (SITE == PAYLOAD) {  // f32(dense + take) + flow @ W
        float d[VEC];
        load8(dense + ((long long)rs * hw + p) * C + c0, d);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          v[i] = __fadd_rn(rnd<L>(__fadd_rn(d[i], l[i])), kt[i]);
      } else {                  // (((cast(dense) + E) + take) + t*w_t) + b
        float d[VEC];
        load8(dense + ((long long)rs * hw + p) * C + c0, d);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float s = rnd<L>(__fadd_rn(rnd<L>(d[i]), rnd<L>(kt[i])));
          s = rnd<L>(__fadd_rn(s, l[i]));
          s = rnd<L>(__fadd_rn(s, rnd<L>(__fmul_rn(tr, st[c0 + i]))));
          v[i] = rnd<L>(__fadd_rn(s, sb[c0 + i]));
        }
      }
      store8(out + ((long long)r * hw + p) * C + c0, v);
    }
  }
}

template <int SITE, bool F32>
int launch(const Args& a, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int need = (a.n_items + THREADS - 1) / THREADS;
  const int blocks = need < sms * 4 ? need : sms * 4;   // one wave
  preact_kernel<SITE, F32><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool F32>
int launch_site(int site, const Args& a, cudaStream_t s) {
  switch (site) {
    case STINF: return launch<STINF, F32>(a, s);
    case SINF: return launch<SINF, F32>(a, s);
    case PAYLOAD: return launch<PAYLOAD, F32>(a, s);
    case SYNTH: return launch<SYNTH, F32>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// site: 0 stinf, 1 sinf, 2 payload, 3 synth; f32: 0 the bfloat16 compute
// types above, 1 all float32. Every pointer but hr 16-byte aligned and its
// tensor contiguous; rows * HH * WW * C / 8 < 2**30 (an item index and the
// grid's stride stay below 2**31).
extern "C" int preact_forward(int site, int f32, const void* lr,
                              const void* iy, const void* ix,
                              const void* dense, const void* hr,
                              long long hr_row, int hr_pix, int K,
                              const void* w, int w_ld, int col_hr, int col_t,
                              const void* t, const void* bias, void* out,
                              int rows, int H, int W, int HH, int WW, int rep,
                              void* stream) {
  if (K < 0 || K > KMAX || rep < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaGetLastError();
  Args a;
  a.lr = lr;
  a.iy = static_cast<const long long*>(iy);
  a.ix = static_cast<const long long*>(ix);
  a.dense = dense;
  a.hr = hr;
  a.hr_row = hr_row;
  a.hr_pix = hr_pix;
  a.K = K;
  a.w = w;
  a.w_ld = w_ld;
  a.col_hr = col_hr;
  a.col_t = col_t;
  a.t = t;
  a.bias = bias;
  a.out = out;
  a.H = H;
  a.W = W;
  a.HH = HH;
  a.WW = WW;
  a.rep = rep;
  a.inner = hr_row == 0 ? rows : 1;
  const long long n = (long long)(rows / a.inner) * HH * WW * (C / VEC);
  if ((long long)rows * HH * WW * (C / VEC) >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  a.n_items = (int)n;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return f32 ? launch_site<true>(site, a, s) : launch_site<false>(site, a, s);
}
