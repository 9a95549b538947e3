// Mamba2 SSD chunked scan on Hopper's tensor cores, each product by
// 3xTF32 (float32 operands split into TF32 parts).
//
// Replaces the Pallas TPU kernel `_kernel` reached through `ssd_scan` in
// src/repro/kernels/ssd_scan.py. For every batch b and head h it runs the
// recurrence h_t = exp(a_t) h_{t-1} + x_t (x) B_t, y_t = C_t . h_t from
// h_0 = 0, a chunk of l steps at a time. With cs the cumulative sum of a
// inside chunk c and S_c the (P x N) state entering it:
//
//   y = (C B^T o L) x + exp(cs) (C S_c^T),   L[i][j] = exp(cs_i - cs_j), i >= j
//   S_{c+1} = exp(cs_last) S_c + s_c,   s_c = sum_j exp(cs_last - cs_j) x_j (x) B_j
//
// Inputs: xdt (B,H,S,P), Bm and Cm (B,S,N) shared by all heads, all
// float32 or all bfloat16 (widened to float32 at load), a (B,H,S) float32;
// output y (B,H,S,P) float32.
//
// Bound on this card: bytes. The function needs, per (b, chunk), C B^T on
// the l (l + 1) / 2 pairs j <= i and, per (b, h, chunk), the masked
// product with x on the same pairs, C S^T and the state update: 22.67
// GFLOP at the serving shape (B = 2, H = 112, S = 4096, P = N = 64,
// l = 128), 0.137 ms by 3xTF32 (165 TFLOP/s on an
// H100 SXM), against 0.143 ms for its 478 MB of x, a, B, C and y at
// 3.35 TB/s. This design adds the chunk states s_c / S_c in device memory
// (B H nc P N floats, written and read twice: ~470 MB more at the serving
// shape), so its own floor is ~0.28 ms.
//
// Design: chunk-parallel, the two-pass scan of Mamba2's own kernels. Four
// kernels behind the one entry point, on the one stream:
//   1. cb_kernel, one block per (chunk, b): C B^T on the tiles that touch
//      the lower triangle (B and C are shared by the heads), into a
//      (B, nc, lp, lp) scratch that every head then reads from L2.
//   2. state_kernel, one block per (chunk, h, b): the chunk's cumulative
//      sum cs (a block-wide scan), its own state s_c = (x o w)^T B with
//      w_j = exp(cs_last - cs_j), and exp(cs_last), into scratch.
//   3. state_pass, one thread per (b, h, p, n), sequential over chunks:
//      S_0 = 0, S_{c+1} = exp(cs_last,c) S_c + s_c in float32, written in
//      place of s_c.
//   4. output_kernel, one block per (chunk, h, b): y = exp(cs) (C S_c^T)
//      + (CB o L) x. L is evaluated only on j <= i (no inf * 0), and the
//      k-steps above a warp's diagonal are skipped.
// Every product runs on the tensor cores by 3xTF32 mma.sync (tf32_mma.cuh),
// each of the three terms issued over several column tiles before the
// next. A block holds one chunk in shared memory, each row padded so the
// fragment reads hit distinct banks: at l = 128 and P = 64, kernel 4 takes
// 90,656 B at N = 64 (two blocks an SM) and 139,808 B at N = 128
// (mamba2-1.3b, one), kernel 2 75,808 B and 108,576 B. Any l, P, N <= 128
// fit (kernel 4 at l = P = N = 128: 206,368 B).
//
// What bounds it now: kernel 4 (about 60% of the time at the serving
// shape on an H100), whose warps own 16 rows each, so the last warp does
// 8x the masked product of the first; and the chunk-state traffic of
// kernels 2-4. Later work (ROADMAP.md queue 2): balance kernel 4's
// warps, fuse the state pass into it, and move the products to wgmma fed
// by TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMax = 128;  // largest l, P and N

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }

// Row strides in elements. "Row" operands are read at (row g, column t):
// a stride of 4 mod 8 words keeps the 32 lanes on distinct banks. "Column"
// operands are read at (row t, column g): 8 mod 16 words does.
template <typename T>
__host__ __device__ constexpr int row_ld(int cols) {
    return cols + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int col_ld(int cols) {
    return cols + 32 / (int)sizeof(T);
}

// Inclusive cumulative sum of a over the chunk (0 past l) into cum[0, lp),
// a warp scan then the warp totals in order; every thread of the block
// calls it, and cum is ready after its trailing barrier.
__device__ void chunk_cumsum(const float* __restrict__ a, int l, int lp,
                             float* cum, float* warp_tot) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float v = tid < l ? a[tid] : 0.0f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_tot[w];
    if (tid < lp) cum[tid] = v;
    __syncthreads();
}

// 1. CB[b, c] = C B^T on the (16-row, 8-column) tiles that touch j <= i
template <typename T>
__global__ void __launch_bounds__(kThreads)
cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
          float* __restrict__ cb, int S, int N, int l, int nc) {
    using namespace tf32;
    constexpr bool kLo = needs_lo<T>();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lp = pad16(l), np = pad16(N), ld = row_ld<T>(np);
    T* cs_ = reinterpret_cast<T*>(smem_raw);  // [lp][ld]
    T* bs = cs_ + lp * ld;                    // [lp][ld]
    const int c = blockIdx.x, b = blockIdx.y;
    const int64_t t0 = (int64_t)c * l;
    load_tile(cs_, ld, Cm + ((int64_t)b * S + t0) * N, N, lp, l, np, N);
    load_tile(bs, ld, Bm + ((int64_t)b * S + t0) * N, N, lp, l, np, N);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = 16 * warp;
    if (m0 >= lp) return;
    const int ntiles = 2 * warp + 2;  // columns 0 .. m0 + 15
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    for (int kk = 0; kk < np; kk += 8) {
        const T* cr = cs_ + (m0 + g) * ld + kk + t;
        const float av[4] = {widen(cr[0]), widen(cr[8 * ld]), widen(cr[4]),
                             widen(cr[8 * ld + 4])};
        uint32_t ahi[4], alo[4];
        split<kLo>(av, ahi, alo);
#pragma unroll
        for (int n0 = 0; n0 < 16; n0 += 2) {
            if (n0 >= ntiles) break;
            uint32_t bhi[2][2], blo[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const T* br = bs + ((n0 + i) * 8 + g) * ld + kk + t;
                const float bv[2] = {widen(br[0]), widen(br[4])};
                split<kLo>(bv, bhi[i], blo[i]);
            }
            mma3<kLo, kLo>(acc + n0, ahi, alo, bhi, blo);
        }
    }
    float* out = cb + ((int64_t)b * nc + c) * lp * lp;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
        if (nt >= ntiles) break;
        const int j = nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + (m0 + g) * lp + j) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (m0 + g + 8) * lp + j) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
}

// 2. s_c = (x o w)^T B (P x N) and exp(cs_last) of chunk c
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
state_kernel(const T* __restrict__ xdt, const float* __restrict__ a,
             const T* __restrict__ Bm, float* __restrict__ states,
             float* __restrict__ decay, int H, int S, int P, int N, int l,
             int nc) {
    using namespace tf32;
    constexpr bool kLo = needs_lo<T>();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lp = pad16(l), pp = pad16(P), np = pad16(N);
    const int xld = col_ld<T>(pp), bld = col_ld<T>(np);
    T* xs = reinterpret_cast<T*>(smem_raw);  // [lp][xld]
    T* bs = xs + lp * xld;                   // [lp][bld]
    float* w = reinterpret_cast<float*>(bs + lp * bld);  // [lp]
    float* cum = w + lp;                                 // [lp]
    float* warp_tot = cum + lp;                          // [kWarps]
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int64_t t0 = (int64_t)c * l, bh = (int64_t)b * H + h;
    load_tile(xs, xld, xdt + (bh * S + t0) * P, P, lp, l, pp, P);
    load_tile(bs, bld, Bm + ((int64_t)b * S + t0) * N, N, lp, l, np, N);
    cp_async_commit();
    chunk_cumsum(a + bh * S + t0, l, lp, cum, warp_tot);
    const float cs_last = cum[l - 1];
    for (int j = threadIdx.x; j < lp; j += kThreads)
        w[j] = j < l ? expf(cs_last - cum[j]) : 0.0f;
    if (threadIdx.x == 0) decay[bh * nc + c] = expf(cs_last);
    cp_async_wait_all();
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int n_groups = (np / 8 + 3) / 4;     // 4 n-tiles (32 columns) each
    const int tasks = (pp / 16) * n_groups;
    float* sb = states + (bh * nc + c) * P * N;
    for (int task = warp; task < tasks; task += kWarps) {
        const int p0 = 16 * (task / n_groups), n0 = 32 * (task % n_groups);
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
        for (int kk = 0; kk < lp; kk += 8) {
            // A (p x j) = x^T o w: A[p][j] = x[j][p] w[j]
            const T* xr = xs + (kk + t) * xld + p0 + g;
            const float w0 = w[kk + t], w1 = w[kk + t + 4];
            const float av[4] = {widen(xr[0]) * w0, widen(xr[8]) * w0,
                                 widen(xr[4 * xld]) * w1,
                                 widen(xr[4 * xld + 8]) * w1};
            uint32_t ahi[4], alo[4], bhi[4][2], blo[4][2];
            split<true>(av, ahi, alo);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {   // columns past np: not stored
                const T* br = bs + (kk + t) * bld + n0 + nt * 8 + g;
                const float bv[2] = {widen(br[0]), widen(br[4 * bld])};
                split<kLo>(bv, bhi[nt], blo[nt]);
            }
            mma3<true, kLo>(acc, ahi, alo, bhi, blo);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int p = p0 + g + 8 * (e >> 1);
                const int n = n0 + nt * 8 + 2 * t + (e & 1);
                if (p < P && n < N) sb[p * N + n] = acc[nt][e];
            }
    }
}

// 3. S_c in place of s_c: S_0 = 0, S_{c+1} = exp(cs_last,c) S_c + s_c
__global__ void __launch_bounds__(kThreads)
state_pass(float* __restrict__ states, const float* __restrict__ decay,
           int64_t BH, int PN, int nc) {
    const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (e >= BH * PN) return;
    const int64_t bh = e / PN, pn = e - bh * PN;
    float* sp = states + bh * nc * PN + pn;
    const float* dp = decay + bh * nc;
    float run = 0.0f;
    for (int c0 = 0; c0 < nc; c0 += 8) {
        float s[8];              // eight loads in flight, then the chain
#pragma unroll
        for (int u = 0; u < 8; ++u)
            s[u] = c0 + u < nc ? sp[(int64_t)(c0 + u) * PN] : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            if (c0 + u >= nc) break;
            sp[(int64_t)(c0 + u) * PN] = run;
            run = fmaf(dp[c0 + u], run, s[u]);
        }
    }
}

// 4. y = exp(cs) (C S_c^T) + (CB o L) x for chunk c of head h
// kNT: n-tiles of 8 columns of y a warp keeps (P <= 8 kNT)
template <typename T, int kNT>
__global__ void __launch_bounds__(kThreads, 2)
output_kernel(const T* __restrict__ xdt, const float* __restrict__ a,
              const T* __restrict__ Cm, const float* __restrict__ cb,
              const float* __restrict__ states, float* __restrict__ y, int H,
              int S, int P, int N, int l, int nc) {
    using namespace tf32;
    constexpr bool kLo = needs_lo<T>();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lp = pad16(l), pp = pad16(P), np = pad16(N);
    const int cld = row_ld<T>(np), xld = col_ld<T>(pp), sld = row_ld<float>(np);
    float* ss = reinterpret_cast<float*>(smem_raw);  // [pp][sld]  S_c
    T* cs_ = reinterpret_cast<T*>(ss + pp * sld);    // [lp][cld]  C
    T* xs = cs_ + lp * cld;                          // [lp][xld]  x
    float* cum = reinterpret_cast<float*>(xs + lp * xld);  // [lp]
    float* warp_tot = cum + lp;                            // [kWarps]
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int64_t t0 = (int64_t)c * l, bh = (int64_t)b * H + h;
    load_tile(ss, sld, states + (bh * nc + c) * P * N, N, pp, P, np, N);
    load_tile(cs_, cld, Cm + ((int64_t)b * S + t0) * N, N, lp, l, np, N);
    load_tile(xs, xld, xdt + (bh * S + t0) * P, P, lp, l, pp, P);
    cp_async_commit();
    chunk_cumsum(a + bh * S + t0, l, lp, cum, warp_tot);
    cp_async_wait_all();
    __syncthreads();

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = 16 * warp;
    if (m0 >= lp) return;
    const int i0 = m0 + g, i1 = i0 + 8;
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

    // C S_c^T: A = C (i x n), B[n][p] = S_c[p][n]
    for (int kk = 0; kk < np; kk += 8) {
        const T* cr = cs_ + i0 * cld + kk + t;
        const float av[4] = {widen(cr[0]), widen(cr[8 * cld]), widen(cr[4]),
                             widen(cr[8 * cld + 4])};
        uint32_t ahi[4], alo[4];
        split<kLo>(av, ahi, alo);
#pragma unroll
        for (int n0 = 0; n0 < kNT; n0 += 4) {   // columns past pp: not stored
            uint32_t bhi[4][2], blo[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float* sr = ss + ((n0 + i) * 8 + g) * sld + kk + t;
                const float bv[2] = {sr[0], sr[4]};
                split<true>(bv, bhi[i], blo[i]);
            }
            mma3<kLo, true>(acc + n0, ahi, alo, bhi, blo);
        }
    }
    const float ci0 = cum[i0], ci1 = cum[i1];
    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
    }

    // (CB o L) x over the keys j <= m0 + 15:
    // A[i][j] = CB[i][j] exp(cs_i - cs_j)
    const float* cbb = cb + ((int64_t)b * nc + c) * lp * lp;
    const float* cb0 = cbb + i0 * lp;
    const float* cb1 = cbb + i1 * lp;
    for (int kk = 0; kk < m0 + 16; kk += 8) {
        const int j0 = kk + t, j1 = j0 + 4;
        const float av[4] = {
            j0 <= i0 ? cb0[j0] * expf(ci0 - cum[j0]) : 0.0f,
            j0 <= i1 ? cb1[j0] * expf(ci1 - cum[j0]) : 0.0f,
            j1 <= i0 ? cb0[j1] * expf(ci0 - cum[j1]) : 0.0f,
            j1 <= i1 ? cb1[j1] * expf(ci1 - cum[j1]) : 0.0f};
        uint32_t ahi[4], alo[4];
        split<true>(av, ahi, alo);
        const T* xr = xs + j0 * xld + g;
#pragma unroll
        for (int n0 = 0; n0 < kNT; n0 += 4) {
            uint32_t bhi[4][2], blo[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = (n0 + i) * 8;
                const float bv[2] = {widen(xr[c]), widen(xr[4 * xld + c])};
                split<kLo>(bv, bhi[i], blo[i]);
            }
            mma3<true, kLo>(acc + n0, ahi, alo, bhi, blo);
        }
    }

    float* yb = y + (bh * S + t0) * P;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1;
            const int p = nt * 8 + 2 * t + (e & 1);
            if (i < l && p < P) yb[(int64_t)i * P + p] = acc[nt][e];
        }
}

// Every size below carries kSlack bytes: the state and output kernels
// compute whole 32- or 64-column groups and read past the last padded
// column of their last row (into columns that are never stored).
constexpr size_t kSlack = 4 * 2 * kMax;

template <typename T>
size_t cb_smem(int l, int N) {
    return sizeof(T) * 2 * (size_t)pad16(l) * row_ld<T>(pad16(N)) + kSlack;
}

template <typename T>
size_t state_smem(int l, int P, int N) {
    const size_t lp = pad16(l);
    return sizeof(T) * lp * (col_ld<T>(pad16(P)) + col_ld<T>(pad16(N))) +
           sizeof(float) * (2 * lp + kWarps) + kSlack;
}

template <typename T>
size_t output_smem(int l, int P, int N) {
    const size_t lp = pad16(l), pp = pad16(P), np = pad16(N);
    return sizeof(float) * pp * row_ld<float>(np) +
           sizeof(T) * lp * (row_ld<T>(np) + col_ld<T>(pp)) +
           sizeof(float) * (lp + kWarps) + kSlack;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) cudaGetLastError();  // clear it
    return err;
}

template <typename T>
int launch(const void* xdt, const float* a, const void* Bm, const void* Cm,
           float* y, float* cb, float* states, float* decay, int B, int H,
           int S, int P, int N, int l, cudaStream_t stream) {
    const T* x = static_cast<const T*>(xdt);
    const T* bm = static_cast<const T*>(Bm);
    const T* cm = static_cast<const T*>(Cm);
    const int nc = S / l;
    auto out_kernel = P <= 64 ? output_kernel<T, 8> : output_kernel<T, 16>;
    const size_t s1 = cb_smem<T>(l, N), s2 = state_smem<T>(l, P, N),
                 s4 = output_smem<T>(l, P, N);
    cudaError_t err;
    if ((err = allow_smem(cb_kernel<T>, s1)) != cudaSuccess ||
        (err = allow_smem(state_kernel<T>, s2)) != cudaSuccess ||
        (err = allow_smem(out_kernel, s4)) != cudaSuccess)
        return static_cast<int>(err);
    cb_kernel<T><<<dim3(nc, B), kThreads, s1, stream>>>(bm, cm, cb, S, N, l,
                                                        nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    state_kernel<T><<<dim3(nc, H, B), kThreads, s2, stream>>>(
        x, a, bm, states, decay, H, S, P, N, l, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int64_t BH = (int64_t)B * H, PN = (int64_t)P * N;
    state_pass<<<(unsigned)((BH * PN + kThreads - 1) / kThreads), kThreads, 0,
                 stream>>>(states, decay, BH, static_cast<int>(PN), nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    out_kernel<<<dim3(nc, H, B), kThreads, s4, stream>>>(
        x, a, cm, cb, states, y, H, S, P, N, l, nc);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers
// of contiguous tensors xdt (B,H,S,P), Bm and Cm (B,S,N), all float32
// (dtype 0) or all bfloat16 (dtype 1); a (B,H,S) and y (B,H,S,P)
// float32; and float32 scratch the caller allocates: cb (B, S/l, lp, lp)
// with lp = l rounded up to 16, states (B,H,S/l,P,N), decay (B,H,S/l).
// 1 <= l, P, N <= 128 and S % l == 0. Four kernel launches on `stream`;
// returns the first cudaGetLastError() that is not cudaSuccess, as an int.
extern "C" int ssd_scan_launch(const void* xdt, const float* a,
                               const void* Bm, const void* Cm, float* y,
                               float* cb, float* states, float* decay, int B,
                               int H, int S, int P, int N, int l, int dtype,
                               void* stream) {
    if (l < 1 || l > kMax || P < 1 || P > kMax || N < 1 || N > kMax ||
        S % l != 0 || (dtype != 0 && dtype != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float>(xdt, a, Bm, Cm, y, cb, states, decay, B, H, S, P,
                             N, l, s);
    return launch<__nv_bfloat16>(xdt, a, Bm, Cm, y, cb, states, decay, B, H,
                                 S, P, N, l, s);
}
