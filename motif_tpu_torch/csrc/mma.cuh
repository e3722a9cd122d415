// Warp-level tensor-core building blocks for the bfloat16 kernels:
// ldmatrix, mma.sync m16n8k16 (bf16 x bf16 -> f32) and the bfloat16 pair
// helpers around them.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane = 4 g + t with
// g = lane >> 2 and t = lane & 3; a register holds two bfloat16s, the lower
// index in the low half:
//   A (16 x 16, row-major)  a0 = (row g,     k 2t, 2t+1)
//                           a1 = (row g + 8, k 2t, 2t+1)
//                           a2 = (row g,     k 2t+8, 2t+9)
//                           a3 = (row g + 8, k 2t+8, 2t+9)
//   B (16 x 8, column-major) b0 = (k 2t, 2t+1;   n g)
//                           b1 = (k 2t+8, 2t+9; n g)
//   C / D (16 x 8, float32) c0 = (row g, n 2t)      c1 = (row g, n 2t+1)
//                           c2 = (row g + 8, n 2t)  c3 = (row g + 8, n 2t+1)
// So the accumulators of the two n8 tiles that cover 16 columns are, once
// rounded and packed in pairs, the A fragment of the next product's k16
// step over the same 16 columns: an activation can stay in
// registers from one layer to the next (frag_from_packed).
//
// A weight stored (n, k) row-major — torch's (out, in) — is the column-major
// B operand as it lies: ldmatrix (not transposed) of 8 rows of 8 bfloat16s
// hands lane 4 g + t the pair (row g, k 2t, 2t+1), which is b0. Rows are
// kept `pad16(K) + 8` elements apart: an odd multiple of 16 bytes, so the 8
// row addresses of one 8 x 8 matrix fall into 8 different 16-byte bank
// groups and ldmatrix is free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma {

// four 8 x 8 bfloat16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, register m receives matrix m in the fragment layout
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16) * b (16 x 8), float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A bfloat16 is the top half of a float.
__device__ __forceinline__ float lo16(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
// (a, b) rounded to nearest even, a in the low half
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
// v rounded to bfloat16, as a float
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The lane's part of the ldmatrix.x4 address of an A tile (16 rows x 16 k)
// in a row-major buffer with rows `ld` elements apart: in elements, to be
// added to the tile's first element. Matrices: (rows 0-7, k 0-7),
// (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15) = a0..a3.
__device__ __forceinline__ int a_lane_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// The same for a pair of B tiles (n8 tiles j and j + 1 over one k16 step)
// of a weight stored (n, k) with rows `ld` apart. Matrices: (tile j, k 0-7),
// (tile j, k 8-15), (tile j + 1, k 0-7), (tile j + 1, k 8-15) = b0, b1 of
// tile j, then of tile j + 1. With `pair` false the upper lanes address
// tile j again (its rows exist; the second tile may not).
__device__ __forceinline__ int b_lane_offset(int lane, int ld, bool pair) {
  const int m = lane >> 3;
  return ((pair ? (m >> 1) * 8 : 0) + (lane & 7)) * ld + (m & 1) * 8;
}

// acc (8 n-tiles of 16 x 8) += a (ksteps k16 steps held in registers) * W,
// W's n-tile 0 / k 0 at shared address `w` (bytes), rows `ld` elements
// apart, `ntiles` n8 tiles. Every branch is uniform over the warp.
template <int KSTEPS>
__device__ __forceinline__ void gemm_regs(float (&acc)[8][4],
                                          const unsigned (&a)[KSTEPS][4],
                                          int ksteps, unsigned w, int ld,
                                          int ntiles, int lane) {
  const int off1 = b_lane_offset(lane, ld, true);
  const int off0 = b_lane_offset(lane, ld, false);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    if (ks < ksteps) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (2 * jp < ntiles) {
          const bool pair = 2 * jp + 1 < ntiles;
          unsigned b[4];
          ldmatrix_x4(b, w + 2 * (2 * jp * 8 * ld + (pair ? off1 : off0) +
                                  ks * 16));
          mma_bf16(acc[2 * jp], a[ks], b[0], b[1]);
          if (pair) mma_bf16(acc[2 * jp + 1], a[ks], b[2], b[3]);
        }
      }
    }
  }
}

// The same with A read from a row-major shared-memory tile of 16 rows,
// `lda` elements apart, first element at shared address `a` (bytes), over
// a run-time number of k16 steps.
__device__ __forceinline__ void gemm_smem(float (&acc)[8][4], unsigned a,
                                          int lda, int ksteps, unsigned w,
                                          int ld, int ntiles, int lane) {
  const int off1 = b_lane_offset(lane, ld, true);
  const int off0 = b_lane_offset(lane, ld, false);
  const unsigned a_lane = a + 2 * a_lane_offset(lane, lda);
  for (int ks = 0; ks < ksteps; ++ks) {
    unsigned af[4];
    ldmatrix_x4(af, a_lane + 32 * ks);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (2 * jp < ntiles) {
        const bool pair = 2 * jp + 1 < ntiles;
        unsigned b[4];
        ldmatrix_x4(b, w + 2 * (2 * jp * 8 * ld + (pair ? off1 : off0) +
                                ks * 16));
        mma_bf16(acc[2 * jp], af, b[0], b[1]);
        if (pair) mma_bf16(acc[2 * jp + 1], af, b[2], b[3]);
      }
    }
  }
}

// Eight n-tiles (64 columns) of bfloat16 pairs in the accumulator layout
// (pk[j][0] = row g, pk[j][1] = row g + 8; columns 8 j + 2t, 2t + 1) as
// the A fragments of the 4 k16 steps over the same columns: a renaming of
// registers.
__device__ __forceinline__ void frag_from_packed(unsigned (&a)[4][4],
                                                 const unsigned (&pk)[8][2]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pk[2 * ks][0];
    a[ks][1] = pk[2 * ks][1];
    a[ks][2] = pk[2 * ks + 1][0];
    a[ks][3] = pk[2 * ks + 1][1];
  }
}

}  // namespace mma
