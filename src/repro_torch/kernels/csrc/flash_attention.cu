// Flash attention forward, float32, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` reached through
// `flash_attention` in src/repro/kernels/flash_attention.py. For every
// batch b, query head h and query row i:
//
//   out[b,h,i] = sum_j p_j v[b,g,j],  p = softmax_j(q[b,h,i].k[b,g,j] / sqrt(hd))
//
// over the keys j the masks leave (causal: j <= i; window w: j > i - w),
// with g = kv_map[h] and 0 for a row that no key is left for. Query i and
// key j sit at positions i and j, both counted from 0.
//
// Bound on this card: operations. In float32 outside the tensor cores
// (67 TFLOP/s on an H100 SXM) the 4 * hd flops per visible (i, j) pair
// take ~25x longer than reading q, k, v and writing out once at 3.35 TB/s
// at the serving shape (B=2, H=32, S=4096, hd=112, causal).
//
// Design. One block of 256 threads per (q tile of 64 rows, h, b). The
// block walks the K/V tiles of 64 keys in order, carrying the running
// row max m, row sum l and the (64 x hd) accumulator (registers) across
// them, as the TPU kernel carries its VMEM scratch across a sequential
// grid axis; blocks share nothing, so no state crosses blocks. Tiles
// wholly above the causal diagonal or below the window band are never
// loaded (the TPU kernel's first/last). Per tile:
//   1. K (transposed) and V land in shared memory; keys past Sk are 0;
//   2. each thread computes a 4 x 4 piece of S = Q K^T (rows ty + 16a,
//      keys tx + 16b) from shared memory, scales it, and masks it to
//      -inf; the tile goes to shared memory;
//   3. four threads per row take the row max, rescale factor
//      alpha = exp(m_old - m_new), p = exp(s - m_new) and the row sum
//      (warp shuffles);
//   4. each thread rescales its 4 x (hd/16) accumulator by alpha and
//      adds P V for its rows and columns (tx + 16c).
// m starts at -1e30, so a row with every key masked so far keeps p = 0
// and alpha = 1 without NaN, and ends with l = 0 and out = 0 (acc / max(l,
// 1e-30)), as the Pallas kernel finalises. Rows past Sq and columns past
// hd are masked at load and store, so any Sq, Sk and hd <= 128 work
// (zamba2's head_dim is 112). Shared memory: Q^T and K^T (hd x 65), V
// (64 x hd), S/P (64 x 65): 104 KB at hd = 112, so two blocks an SM.
//
// Later work (ROADMAP.md queue 2): wgmma on TF32 or bf16 tiles fed by TMA
// with a producer warp, which this f32 contract does not allow yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kColsPerThread = kMaxHd / 16;
constexpr int kLd = kBK + 1;  // row stride of Q^T, K^T and S (odd: no bank conflicts)
constexpr float kNegInit = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int32_t* __restrict__ kv_map,
                       float* __restrict__ out, int H, int KH, int Sq,
                       int Sk, int hd, int causal, int window, float scale) {
    extern __shared__ float smem[];
    float* qt = smem;                    // [hd][kLd]   Q^T
    float* kt = qt + hd * kLd;           // [hd][kLd]   K^T
    float* vs = kt + hd * kLd;           // [kBK][hd]   V
    float* ps = vs + kBK * hd;           // [kBQ][kLd]  S, then P
    float* m_s = ps + kBQ * kLd;         // [kBQ]
    float* l_s = m_s + kBQ;              // [kBQ]
    float* alpha_s = l_s + kBQ;          // [kBQ]

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int q0 = blockIdx.x * kBQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int g = kv_map[h];
    const float* qb = q + ((int64_t)(b * H + h) * Sq) * hd;
    const float* kb = k + ((int64_t)(b * KH + g) * Sk) * hd;
    const float* vb = v + ((int64_t)(b * KH + g) * Sk) * hd;
    float* ob = out + ((int64_t)(b * H + h) * Sq) * hd;

    for (int e = tid; e < kBQ * hd; e += kThreads) {
        const int r = e / hd, d = e % hd;
        qt[d * kLd + r] = (q0 + r < Sq) ? qb[(int64_t)(q0 + r) * hd + d] : 0.0f;
    }
    if (tid < kBQ) {
        m_s[tid] = kNegInit;
        l_s[tid] = 0.0f;
    }

    // keys this tile of queries can see: [first_key, last_key]
    int last_key = Sk - 1;
    if (causal) last_key = min(last_key, q0 + kBQ - 1);
    int first_key = 0;
    if (window > 0) first_key = max(q0 - (window - 1), 0);

    float acc[4][kColsPerThread];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[a][c] = 0.0f;

    if (first_key <= last_key) {
        for (int k0 = (first_key / kBK) * kBK; k0 <= last_key; k0 += kBK) {
            __syncthreads();             // previous tile's P V is done
            for (int e = tid; e < kBK * hd; e += kThreads) {
                const int j = e / hd, d = e % hd;
                const bool in = k0 + j < Sk;
                const int64_t off = (int64_t)(k0 + j) * hd + d;
                kt[d * kLd + j] = in ? kb[off] : 0.0f;
                vs[j * hd + d] = in ? vb[off] : 0.0f;
            }
            __syncthreads();

            // 2. S = Q K^T for rows ty + 16a, keys tx + 16c
            float s[4][4];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
            for (int d = 0; d < hd; ++d) {
                float qa[4], kc[4];
#pragma unroll
                for (int a = 0; a < 4; ++a) qa[a] = qt[d * kLd + ty + 16 * a];
#pragma unroll
                for (int c = 0; c < 4; ++c) kc[c] = kt[d * kLd + tx + 16 * c];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int i = q0 + ty + 16 * a;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = k0 + tx + 16 * c;
                    bool ok = j < Sk;
                    if (causal) ok = ok && j <= i;
                    if (window > 0) ok = ok && j > i - window;
                    ps[(ty + 16 * a) * kLd + tx + 16 * c] =
                        ok ? s[a][c] * scale : -INFINITY;
                }
            }
            __syncthreads();

            // 3. online softmax: four neighbouring lanes share a row
            {
                const int r = tid / 4, part = tid % 4;
                float* row = ps + r * kLd;
                float mx = -INFINITY;
                for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, row[c]);
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                const float m_old = m_s[r];
                const float m_new = fmaxf(m_old, mx);   // finite: >= -1e30
                float sum = 0.0f;
                for (int c = part; c < kBK; c += 4) {
                    const float p = expf(row[c] - m_new);  // masked: exp(-inf) = 0
                    row[c] = p;
                    sum += p;
                }
                sum += __shfl_xor_sync(0xffffffffu, sum, 1);
                sum += __shfl_xor_sync(0xffffffffu, sum, 2);
                __syncwarp();
                if (part == 0) {
                    const float alpha = expf(m_old - m_new);
                    alpha_s[r] = alpha;
                    l_s[r] = l_s[r] * alpha + sum;
                    m_s[r] = m_new;
                }
            }
            __syncthreads();

            // 4. acc = alpha * acc + P V for rows ty + 16a, columns tx + 16c
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float al = alpha_s[ty + 16 * a];
#pragma unroll
                for (int c = 0; c < kColsPerThread; ++c) acc[a][c] *= al;
            }
            for (int j = 0; j < kBK; ++j) {
                float pa[4];
#pragma unroll
                for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * kLd + j];
#pragma unroll
                for (int c = 0; c < kColsPerThread; ++c) {
                    const int d = tx + 16 * c;
                    if (d < hd) {
                        const float vv = vs[j * hd + d];
#pragma unroll
                        for (int a = 0; a < 4; ++a)
                            acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
                    }
                }
            }
        }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        if (q0 + r >= Sq) continue;
        const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
            const int d = tx + 16 * c;
            if (d < hd) ob[(int64_t)(q0 + r) * hd + d] = acc[a][c] * inv;
        }
    }
}

size_t smem_bytes(int hd) {
    return sizeof(float) * (2 * (size_t)hd * kLd + (size_t)kBK * hd +
                            (size_t)kBQ * kLd + 3 * kBQ);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers
// of contiguous float32 tensors q (B,H,Sq,hd), k and v (B,KH,Sk,hd), out
// (B,H,Sq,hd), and kv_map (H,) int32 with entries in [0, KH). hd in
// 1..128; causal 0 or 1; window <= 0 means none. Launches on `stream` and
// returns cudaGetLastError() as an int (a launch the card refuses, for
// example for its shared memory, never runs and reports here).
extern "C" int flash_attention_launch(const float* q, const float* k,
                                      const float* v, const int32_t* kv_map,
                                      float* out, int B, int H, int KH,
                                      int Sq, int Sk, int hd, int causal,
                                      int window, void* stream) {
    if (hd < 1 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(hd);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it: the next launch must not report it
        return static_cast<int>(err);
    }
    const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    flash_attention_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        q, k, v, kv_map, out, H, KH, Sq, Sk, hd, causal, window,
        1.0f / sqrtf(static_cast<float>(hd)));
    return static_cast<int>(cudaGetLastError());
}
