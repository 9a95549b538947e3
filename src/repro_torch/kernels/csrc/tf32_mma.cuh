// Tensor-core products of float32 operands by 3xTF32, and asynchronous
// tile loads, shared by flash_attention.cu and ssd_scan.cu.
//
// 3xTF32. A TF32 operand keeps 10 mantissa bits, so one TF32 product
// misses the float32 tolerances of the kernels that include this file.
// Each float32 operand x is split in registers into
//   hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi)
// and a tile product issues hi*lo, lo*hi and hi*hi (the lo*lo term is
// below float32 rounding). A bfloat16 value widened to float32 is exact
// in TF32 (7 mantissa bits), so its lo part is 0 and the products with it
// are skipped: `kLo` below is false for such an operand.
//
// Each mma rounds its sum at the magnitude of its accumulator. mma3 adds
// all three terms into one accumulator, which is enough for a sum over a
// few dozen k-steps; mma3_sep keeps the small terms in an accumulator of
// their own (flash_attention.cu: with the three terms in its running
// output the error on the card was several times that of a plain float32
// version; PERF.md).
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, per lane
// (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t)    a1 (g + 8, t)   a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k t, n g)                b1 (k t + 4, n g)
//   C (16 x 8):       c0 (g, 2t)   c1 (g, 2t + 1)  c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// an operand of type T needs its lo part unless it is exact in TF32
template <typename T>
__host__ __device__ constexpr bool needs_lo() { return sizeof(T) == 4; }

__device__ __forceinline__ uint32_t round_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// hi/lo parts of n values; lo left unset when kLo is false (hi is then
// the value itself, exact in TF32)
template <bool kLo, int n>
__device__ __forceinline__ void split(const float (&x)[n], uint32_t (&hi)[n],
                                      uint32_t (&lo)[n]) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
        if constexpr (kLo) {
            hi[i] = round_tf32(x[i]);
            lo[i] = round_tf32(x[i] - __uint_as_float(hi[i]));
        } else {
            hi[i] = __float_as_uint(x[i]);
        }
    }
}

// not volatile: the compiler may interleave independent tile products,
// so that the three dependent products of one tile do not wait in a row
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += A B_i for n tiles by 3xTF32: the small terms first,
// then hi*hi, each term over all n tiles before the next (n independent
// products between two that depend on each other)
template <bool kALo, bool kBLo, int n>
__device__ __forceinline__ void mma3(float (*d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[n][2],
                                     const uint32_t (&blo)[n][2]) {
    if constexpr (kBLo) {
#pragma unroll
        for (int i = 0; i < n; ++i)
            mma(d[i], ahi, blo[i]);
    }
    if constexpr (kALo) {
#pragma unroll
        for (int i = 0; i < n; ++i)
            mma(d[i], alo, bhi[i]);
    }
#pragma unroll
    for (int i = 0; i < n; ++i)
        mma(d[i], ahi, bhi[i]);
}

// As mma3, with hi*hi into d and the small terms into dlo
template <bool kALo, bool kBLo, int n>
__device__ __forceinline__ void mma3_sep(float (*d)[4], float (*dlo)[4],
                                         const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4],
                                         const uint32_t (&bhi)[n][2],
                                         const uint32_t (&blo)[n][2]) {
    if constexpr (kBLo) {
#pragma unroll
        for (int i = 0; i < n; ++i)
            mma(dlo[i], ahi, blo[i]);
    }
    if constexpr (kALo) {
#pragma unroll
        for (int i = 0; i < n; ++i)
            mma(dlo[i], alo, bhi[i]);
    }
#pragma unroll
    for (int i = 0; i < n; ++i)
        mma(d[i], ahi, bhi[i]);
}

// Four 8 x 4 float32 matrices from shared memory, one register of each a
// lane: lane l names row l % 8 of matrix l / 8, and register m of lane
// (g, t) holds row g, column t of matrix m (ldmatrix on 16-bit pairs).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const float* row) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// -- asynchronous copies into shared memory ---------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first `bytes` (16 or 0) come from src and the
// rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy rows [0, rows) x columns [0, cols) of a row-major matrix at src
// (row length ld elements) into shared memory at dst (row stride sld
// elements), zero where the row is >= nrows or the column >= ncols.
// cols is a multiple of 16 / sizeof(T), and dst and sld keep each row
// 16-byte aligned; cols <= blockDim.x. 16-byte cp.async when every row
// of src is 16-byte aligned and ncols fills whole 16-byte pieces; else
// 4-byte cp.async for float, or plain loads for bfloat16. Call
// cp_async_commit() after.
// Each thread copies one column piece of every (blockDim.x / pieces)-th
// row, so there is one division a call and none per piece.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int sld, const T* src,
                                          int64_t ld, int rows, int nrows,
                                          int cols, int ncols) {
    constexpr int kVec = 16 / sizeof(T);
    const int tid = threadIdx.x, nt = blockDim.x;
    if (ld % kVec == 0 && ncols % kVec == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
        const int vc = cols / kVec, step = nt / vc;  // cols <= kVec * nt
        const int c = (tid % vc) * kVec;
        if (tid >= step * vc) return;
        for (int r = tid / vc; r < rows; r += step) {
            const bool ok = r < nrows && c < ncols;
            cp_async16(dst + r * sld + c, ok ? src + r * ld + c : src,
                       ok ? 16 : 0);
        }
    } else {
        const int step = nt / cols, c = tid % cols;
        if (tid >= step * cols) return;
        for (int r = tid / cols; r < rows; r += step) {
            const bool ok = r < nrows && c < ncols;
            if constexpr (sizeof(T) == 4) {
                cp_async4(dst + r * sld + c, ok ? src + r * ld + c : src,
                          ok ? 4 : 0);
            } else {
                dst[r * sld + c] = ok ? src[r * ld + c]
                                      : __float2bfloat16_rn(0.0f);
            }
        }
    }
}

}  // namespace tf32
