// Flash attention forward on Hopper's tensor cores, each product by
// 3xTF32 (float32 operands split into TF32 parts).
//
// Replaces the Pallas TPU kernel `_kernel` reached through
// `flash_attention` in src/repro/kernels/flash_attention.py. For every
// batch b, query head h and query row i:
//
//   out[b,h,i] = sum_j p_j v[b,g,j],  p = softmax_j(q[b,h,i].k[b,g,j] / sqrt(hd))
//
// over the keys j the masks leave (causal: j <= i; window w: j > i - w),
// with g = kv_map[h] and 0 for a row that no key is left for. Query i and
// key j sit at positions i and j, both counted from 0. q, k, v are float32
// or bfloat16 (one type), widened to float32 at load; out has their type.
//
// Bound on this card: operations. 4 * hd flops per visible (i, j) pair,
// by 3xTF32 (tf32_mma.cuh: three TF32 products per tile, 495 / 3 = 165
// TFLOP/s on an H100 SXM): 1.46 ms at the serving
// shape (B=2, H=32, S=4096, hd=112, causal: 537 M visible pairs), against
// 0.14 ms to read q, k, v and write out once at 3.35 TB/s.
//
// Design (FlashAttention-2 on mma.sync). One block of 8 warps per (q tile
// of 128 rows, h, b); each warp owns 16 query rows. The block walks the
// K/V tiles of 64 keys that its rows can see (tiles above the causal
// diagonal or below the window band are never loaded), carrying the row
// max m, the row sum l and the 16 x hd accumulator O in registers.
//   - K and V tiles arrive through a 2-stage ring of cp.async copies:
//     the next tile loads while this one computes.
//   - S = Q K^T for a warp's 16 rows and 64 keys stays in registers
//     (8 n-tiles of m16n8k8, hd / 8 k-steps), each product by 3xTF32,
//     its small terms (hi*lo, lo*hi) in an accumulator of their own
//     (tf32_mma.cuh). Q and K fragments come from shared memory by
//     ldmatrix and are split in registers; each of the three terms is
//     issued over all n-tiles before the next, so no product waits on
//     the one before it.
//   - The online softmax runs in registers, in log2 units (the scale
//     times log2(e) folded into one multiply, then exp2): a lane holds
//     2 rows x 16 keys, and the row max takes two quad shuffles. l stays
//     a per-lane partial sum until the end; O is rescaled only when a
//     row max of the warp moved. Only tiles on the causal diagonal, the
//     window's edge or the end of the keys evaluate a mask; a warp whose
//     rows see no key of a tile skips it.
//   - P is the A operand of O += P V with no shuffle. The accumulator
//     gives lane (g, t) keys 2t and 2t + 1 of each 8-key group, while an
//     A fragment holds columns t and t + 4. So the keys of each group are
//     relabelled: A column t is key 2t and A column t + 4 is key 2t + 1.
//     Then a0..a3 are c0, c2, c1, c3, and the B fragment of V loads rows
//     2t (b0) and 2t + 1 (b1) to match. Each warp splits its V fragments
//     in registers.
//   - O's small terms go into an accumulator of their own too, added to
//     O at the end. Summed into the running O by the tensor cores, they
//     were lost to its rounding: the error was several times that of a
//     plain float32 version (PERF.md). V's fragments are split for half
//     of O's n-tiles at a time, to save registers.
//   - m starts at -1e30 and masked scores are -inf, so a row with every
//     key masked keeps p = 0 and alpha = 1 and ends with l = 0 and out = 0
//     (acc / max(l, 1e-30)), as the Pallas kernel finalises.
// Shared memory: Q (128 rows) and two stages of K and V (64 rows each),
// every row hd rounded up to 8 (zero past hd) plus 16 bytes; the padding
// keeps the fragment reads free of bank conflicts. 178,176 B at hd = 112
// in float32 (202,752 B at hd 128), so one block (8 warps) an SM.
// Causal q tiles launch longest first. Any Sq, Sk and hd <= 128 work.
//
// What bounds it now: at one block of 8 warps an SM (shared memory), the
// latency of the dependent 3xTF32 products and the splits of the Q, K and
// V fragments that each warp redoes. Later work (ROADMAP.md queue 2):
// wgmma fed by TMA from a producer warp, with the split K and V kept in
// shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per K/V tile
constexpr int kMaxHd = 128;
constexpr float kNegInit = -1e30f;

// kNT: n-tiles of 8 columns of O a warp keeps. q, k and v rows are held
// kNT * 8 wide in shared memory, zero past hd, plus 16 bytes
template <typename T, int kNT>
__host__ __device__ constexpr int stride() {
    return 8 * kNT + 16 / (int)sizeof(T);
}

// Q, then two stages of K and of V
template <typename T, int kNT>
__host__ __device__ constexpr size_t smem_bytes() {
    return sizeof(T) * (kBQ + 4 * kBK) * stride<T, kNT>();
}

template <typename T, int kNT>
__global__ void __launch_bounds__(kThreads, 8 / kWarps)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ kv_map, T* __restrict__ out,
                       int H, int KH, int Sq, int Sk, int hd, int causal,
                       int window, float scale_log2) {
    using namespace tf32;
    constexpr bool kLo = needs_lo<T>();
    constexpr int hdp = 8 * kNT, sld = stride<T, kNT>();
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* qs = reinterpret_cast<T*>(smem_raw);  // [kBQ][sld]
    T* ks = qs + kBQ * sld;                  // [2][kBK][sld]
    T* vs = ks + 2 * kBK * sld;              // [2][kBK][sld]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    // causal: the longest q tiles (the last) first
    const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int q0 = qt * kBQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = kv_map[h];
    const T* qb = q + ((int64_t)(b * H + h) * Sq) * hd;
    const T* kb = k + ((int64_t)(b * KH + kvh) * Sk) * hd;
    const T* vb = v + ((int64_t)(b * KH + kvh) * Sk) * hd;
    T* ob = out + ((int64_t)(b * H + h) * Sq) * hd;

    load_tile(qs, sld, qb + (int64_t)q0 * hd, hd, kBQ, Sq - q0, hdp, hd);

    // keys this tile of queries can see: [first_key, last_key]
    int last_key = Sk - 1;
    if (causal) last_key = min(last_key, q0 + kBQ - 1);
    const int first_key = window > 0 ? max(q0 - (window - 1), 0) : 0;
    const int kt0 = first_key / kBK;
    const int n_tiles = first_key <= last_key ? last_key / kBK - kt0 + 1 : 0;
    if (n_tiles > 0) {
        const int k0 = kt0 * kBK;
        load_tile(ks, sld, kb + (int64_t)k0 * hd, hd, kBK, Sk - k0, hdp, hd);
        load_tile(vs, sld, vb + (int64_t)k0 * hd, hd, kBK, Sk - k0, hdp, hd);
    }
    cp_async_commit();

    const int r0 = q0 + 16 * warp;     // this warp's first query row
    const T* qw = qs + 16 * warp * sld;
    // ldmatrix rows of this lane: an A fragment of Q (a0..a3), and the B
    // fragments of K for two n-tiles (b0, b1 of the first, then the second)
    const int lq = ((lane >> 3) & 1) * 8 + (lane & 7), cq = (lane >> 4) * 4;
    const int lk = (lane >> 4) * 8 + (lane & 7), ck = ((lane >> 3) & 1) * 4;
    float m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f};
    float o[kNT][4], o_lo[kNT][4];   // O's hi*hi sums and small terms
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = o_lo[nt][e] = 0.0f;

    for (int it = 0; it < n_tiles; ++it) {
        const int k0 = (kt0 + it) * kBK, st = it & 1;
        cp_async_wait_all();
        __syncthreads();     // tile `it` landed; every warp is done with it - 1
        if (it + 1 < n_tiles) {
            const int k1 = k0 + kBK;
            load_tile(ks + (st ^ 1) * kBK * sld, sld, kb + (int64_t)k1 * hd,
                      hd, kBK, Sk - k1, hdp, hd);
            load_tile(vs + (st ^ 1) * kBK * sld, sld, vb + (int64_t)k1 * hd,
                      hd, kBK, Sk - k1, hdp, hd);
            cp_async_commit();
        }
        // does any row r0..r0+15 see any key k0..k0+63?
        if (r0 >= Sq || (causal && k0 > r0 + 15) ||
            (window > 0 && k0 + kBK - 1 <= r0 - window))
            continue;
        const bool full = (!causal || k0 + kBK - 1 <= r0) &&
                          (window <= 0 || k0 > r0 + 15 - window) &&
                          k0 + kBK <= Sk;
        const T* kst = ks + st * kBK * sld;

        // S = Q K^T: 16 rows x 64 keys, the small terms in s_lo
        constexpr int kST = kBK / 8;     // n-tiles of S
        float s[kST][4], s_lo[kST][4];
#pragma unroll
        for (int nt = 0; nt < kST; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = s_lo[nt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < hdp; kk += 8) {
            uint32_t ahi[4], alo[4], bhi[kST][2], blo[kST][2];
            if constexpr (sizeof(T) == 4) {
                uint32_t r[4];
                ldmatrix_x4(r, reinterpret_cast<const float*>(
                                   qw + lq * sld + kk + cq));
                const float av[4] = {
                    __uint_as_float(r[0]), __uint_as_float(r[1]),
                    __uint_as_float(r[2]), __uint_as_float(r[3])};
                split<kLo>(av, ahi, alo);
#pragma unroll
                for (int nt = 0; nt < kST; nt += 2) {
                    ldmatrix_x4(r, reinterpret_cast<const float*>(
                                       kst + (nt * 8 + lk) * sld + kk + ck));
                    const float b0[2] = {__uint_as_float(r[0]),
                                         __uint_as_float(r[1])};
                    const float b1[2] = {__uint_as_float(r[2]),
                                         __uint_as_float(r[3])};
                    split<kLo>(b0, bhi[nt], blo[nt]);
                    split<kLo>(b1, bhi[nt + 1], blo[nt + 1]);
                }
            } else {
                const float av[4] = {widen(qw[g * sld + kk + t]),
                                     widen(qw[(g + 8) * sld + kk + t]),
                                     widen(qw[g * sld + kk + t + 4]),
                                     widen(qw[(g + 8) * sld + kk + t + 4])};
                split<kLo>(av, ahi, alo);
#pragma unroll
                for (int nt = 0; nt < kST; ++nt) {
                    const T* kr = kst + (nt * 8 + g) * sld + kk + t;
                    const float bv[2] = {widen(kr[0]), widen(kr[4])};
                    split<kLo>(bv, bhi[nt], blo[nt]);
                }
            }
            mma3_sep<kLo, kLo>(s, s_lo, ahi, alo, bhi, blo);
        }

        // scale (into log2 units), mask where the tile needs it, row max
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < kST; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = kLo ? s[nt][e] + s_lo[nt][e] : s[nt][e];
                x *= scale_log2;
                if (!full) {
                    const int i = r0 + g + 8 * (e >> 1);
                    const int j = k0 + nt * 8 + 2 * t + (e & 1);
                    bool ok = j < Sk;
                    if (causal) ok = ok && j <= i;
                    if (window > 0) ok = ok && j > i - window;
                    x = ok ? x : -INFINITY;
                }
                s[nt][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);  // finite: >= -1e30
            alpha[r] = exp2f(m[r] - m_new);
            m[r] = m_new;
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 0; nt < kST; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[nt][e] - m[e >> 1]);  // masked: 0
                s[nt][e] = p;
                l[e >> 1] += p;
            }
        // rescale O only where a row max of the warp moved
        if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    o[nt][e] *= alpha[e >> 1];
                    o_lo[nt][e] *= alpha[e >> 1];
                }
        }

        // O += P V, one 8-key group at a time; A column t is key 2t and
        // A column t + 4 is key 2t + 1 (see the note at the top); hi*hi
        // into O, the small terms into O_lo
        const T* vst = vs + st * kBK * sld + 2 * t * sld + g;
#pragma unroll
        for (int kg = 0; kg < kST; ++kg) {
            const float pv[4] = {s[kg][0], s[kg][2], s[kg][1], s[kg][3]};
            uint32_t ahi[4], alo[4];
            split<true>(pv, ahi, alo);
#pragma unroll
            for (int n0 = 0; n0 < kNT; n0 += kNT / 2) {
                uint32_t bhi[kNT / 2][2], blo[kNT / 2][2];
#pragma unroll
                for (int i = 0; i < kNT / 2; ++i) {
                    const T* v0 = vst + kg * 8 * sld + (n0 + i) * 8;
                    const float bv[2] = {widen(v0[0]), widen(v0[sld])};
                    split<kLo>(bv, bhi[i], blo[i]);
                }
                mma3_sep<true, kLo>(o + n0, o_lo + n0, ahi, alo, bhi, blo);
            }
        }
    }
    cp_async_wait_all();
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] += o_lo[nt][e];

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int i = r0 + g + 8 * r;
        if (i >= Sq) continue;
        const float inv = 1.0f / fmaxf(l[r], 1e-30f);
        T* orow = ob + (int64_t)i * hd;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int d = nt * 8 + 2 * t + c;
                if (d < hd) orow[d] = narrow<T>(o[nt][2 * r + c] * inv);
            }
    }
}

template <typename T, int kNT>
int launch(const void* q, const void* k, const void* v, const int32_t* kv_map,
           void* out, int B, int H, int KH, int Sq, int Sk, int hd, int causal,
           int window, cudaStream_t stream) {
    const size_t smem = smem_bytes<T, kNT>();
    auto kernel = flash_attention_kernel<T, kNT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it: the next launch must not report it
        return static_cast<int>(err);
    }
    const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_map, static_cast<T*>(out), H, KH, Sq,
        Sk, hd, causal, window,
        1.4426950408889634f / sqrtf(static_cast<float>(hd)));  // log2(e)
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v,
              const int32_t* kv_map, void* out, int B, int H, int KH, int Sq,
              int Sk, int hd, int causal, int window, cudaStream_t stream) {
    if (hd <= 32)
        return launch<T, 4>(q, k, v, kv_map, out, B, H, KH, Sq, Sk, hd,
                            causal, window, stream);
    if (hd <= 64)
        return launch<T, 8>(q, k, v, kv_map, out, B, H, KH, Sq, Sk, hd,
                            causal, window, stream);
    if (hd <= 112)           // zamba2's head_dim: no column tile wasted
        return launch<T, 14>(q, k, v, kv_map, out, B, H, KH, Sq, Sk, hd,
                             causal, window, stream);
    return launch<T, 16>(q, k, v, kv_map, out, B, H, KH, Sq, Sk, hd, causal,
                         window, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers
// of contiguous tensors q (B,H,Sq,hd), k and v (B,KH,Sk,hd) and out
// (B,H,Sq,hd), all float32 (dtype 0) or all bfloat16 (dtype 1), and
// kv_map (H,) int32 with entries in [0, KH). hd in 1..128; causal 0 or
// 1; window <= 0 means none. One kernel launch on `stream`; returns
// cudaGetLastError() as an int (a launch the card refuses never runs
// and reports here).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int32_t* kv_map,
                                      void* out, int B, int H, int KH,
                                      int Sq, int Sk, int hd, int causal,
                                      int window, int dtype, void* stream) {
    if (hd < 1 || hd > kMaxHd || (dtype != 0 && dtype != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_hd<float>(q, k, v, kv_map, out, B, H, KH, Sq, Sk, hd,
                                causal, window, s);
    return launch_hd<__nv_bfloat16>(q, k, v, kv_map, out, B, H, KH, Sq, Sk,
                                    hd, causal, window, s);
}
