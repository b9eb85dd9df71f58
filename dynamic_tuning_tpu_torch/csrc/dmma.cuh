// The FP64 tensor-core primitive (DMMA) of the exact fp32 route: the
// m16n8k8 mma.sync with float64 operands and accumulators (sm_90; wgmma has
// no f64 form).  Fragment layout of a warp, g = lane / 4, t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1)
// The product of two fp32 values is exact in float64 (48 significant bits
// of 53), so a sum of such products taken on DMMA differs from the plain
// version's float64 sum only in its order, as a sum on the FP64 units does.
#pragma once

#include "common.cuh"

namespace dyt {

// c += a * b
__device__ __forceinline__ void dmma_16x8x8(double (&c)[4],
                                            const double (&a)[4],
                                            double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// 4-byte global -> shared copy (rows whose start is not on 16 bytes);
// src_bytes == 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

}  // namespace dyt
