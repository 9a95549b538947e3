// Mamba2 SSD chunked scan, float32, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` reached through `ssd_scan` in
// src/repro/kernels/ssd_scan.py. For every batch b and head h it runs the
// recurrence h_t = exp(a_t) h_{t-1} + x_t (x) B_t, y_t = C_t . h_t from
// h_0 = 0, a chunk of l steps at a time. With cs the cumulative sum of a
// inside the chunk and S the carried (P x N) state, each chunk computes
//
//   y = (C B^T o L) x + exp(cs) (C S^T),   L[i][j] = exp(cs_i - cs_j), i >= j
//   S <- exp(cs_last) S + sum_j exp(cs_last - cs_j) x_j (x) B_j
//
// Inputs: xdt (B,H,S,P), a (B,H,S), Bm and Cm (B,S,N) shared by all heads;
// output y (B,H,S,P); all float32.
//
// Bound on this card: operations. The function needs, per (b, chunk),
// C B^T on the l (l + 1) / 2 pairs j <= i (L is 0 above them; B and C are
// shared by the heads) and, per (b, h, chunk), the masked product with x
// on the same pairs, C S^T and the state update: 2 t N + H (2 t P +
// 4 l N P) flops with t = l (l + 1) / 2, ~3.15 MFLOP a head at l = 128,
// P = N = 64. At the serving shape (B = 2, H = 112, S = 4096) that is
// ~22.7 GFLOP, ~0.34 ms in float32 outside the tensor cores (67 TFLOP/s
// on an H100 SXM), against ~0.14 ms for its 478 MB of x, a, B, C and y
// at 3.35 TB/s. This kernel issues about twice those flops: full l x l
// squares, and C B^T once per head.
//
// Design. The TPU kernel carries S in VMEM across a sequential grid axis
// of chunks. Blocks carry nothing between them on this card, so one block
// of 256 threads owns one (b, h) and walks its chunks in a loop, with S
// in shared memory. Per chunk, between barriers:
//   1. x, B, C and a of the chunk land in shared memory (B and C with an
//      odd row stride, so the column reads below hit distinct banks);
//   2. warp 0 takes the inclusive cumulative sum cs of a (a warp scan);
//   3. every thread fills exp(cs_last - cs_j), exp(cs_i), and its 8 x 8
//      piece (rows ty + 16a, columns tx + 16c) of M = C B^T o L, zero
//      above the diagonal (the masked exponent is never evaluated);
//   4. every thread computes its rows ty + 16a and columns tx + 16c of
//      y = exp(cs) (C S^T) + M x and stores them;
//   5. every thread updates its entries (p = ty + 16a, n = tx + 16c) of
//      S from its old value, x, B and the decay weights.
// The P and N tiles of steps 4 and 5 are 4 wide when P, N <= 64 and 8
// wide otherwise (a template), so that at P = N = 64 no thread multiplies
// padding. Any l, P, N up to 128 work whose chunk fits in shared memory:
// 184 KB at l = 128, P = N = 64 (zamba2-7b), so one block an SM.
//
// What would fill the card (later work, ROADMAP.md queue 2): at the
// serving shape there are 2 x 112 = 224 blocks for 132 SMs, two waves
// with one block an SM and the second wave 70% full. A two-pass scan
// would first compute every chunk's own state contribution in parallel
// (B x H x chunks blocks), then run a short sequential pass over the
// chunk states, then the chunk outputs in parallel. C B^T is the same
// for every head of a batch row, so computing it once per (b, chunk)
// instead of once per (b, h, chunk) removes a third of the flops issued,
// and skipping the tiles above the diagonal halves the masked product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 128;        // largest l, P and N
constexpr int kPer = kMax / 16;  // chunk rows or columns per thread

// kPN: the P and N entries a thread owns along each of those axes
template <int kPN>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ a,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, int H, int S, int P, int N, int l) {
    extern __shared__ float smem[];
    const int ns = N | 1;            // odd row stride of B, C and S
    const int lm = l + 1;            // row stride of M
    float* xs = smem;                // [l][P]
    float* bs = xs + l * P;          // [l][ns]
    float* cs_ = bs + l * ns;        // [l][ns]
    float* ms = cs_ + l * ns;        // [l][lm]
    float* ss = ms + l * lm;         // [P][ns]  carried state
    float* cum = ss + P * ns;        // [l]      cs
    float* wdec = cum + l;           // [l]      exp(cs_last - cs_j)
    float* ecs = wdec + l;           // [l]      exp(cs_i)

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int ty = tid / 16, tx = tid % 16;
    const int h = blockIdx.x, b = blockIdx.y;
    const float* xb = xdt + (int64_t)(b * H + h) * S * P;
    const float* ab = a + (int64_t)(b * H + h) * S;
    const float* Bb = Bm + (int64_t)b * S * N;
    const float* Cb = Cm + (int64_t)b * S * N;
    float* yb = y + (int64_t)(b * H + h) * S * P;

    for (int e = tid; e < P * ns; e += kThreads) ss[e] = 0.0f;

    for (int t0 = 0; t0 < S; t0 += l) {
        // 1. the chunk's inputs
        __syncthreads();                 // the previous chunk is done
        for (int e = tid; e < l * P; e += kThreads)
            xs[e] = xb[(int64_t)t0 * P + e];
        for (int e = tid; e < l * N; e += kThreads) {
            const int i = e / N, n = e % N;
            bs[i * ns + n] = Bb[(int64_t)t0 * N + e];
            cs_[i * ns + n] = Cb[(int64_t)t0 * N + e];
        }
        for (int i = tid; i < l; i += kThreads) cum[i] = ab[t0 + i];
        __syncthreads();

        // 2. inclusive cumulative sum of a over the chunk
        if (warp == 0) {
            float carry = 0.0f;
            for (int base = 0; base < l; base += 32) {
                const int i = base + lane;
                float v = i < l ? cum[i] : 0.0f;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const float t = __shfl_up_sync(0xffffffffu, v, o);
                    if (lane >= o) v += t;
                }
                v += carry;
                if (i < l) cum[i] = v;
                carry = __shfl_sync(0xffffffffu, v, 31);
            }
        }
        __syncthreads();

        // 3. decay weights and M = C B^T o L
        const float cs_last = cum[l - 1];
        for (int i = tid; i < l; i += kThreads) {
            wdec[i] = expf(cs_last - cum[i]);
            ecs[i] = expf(cum[i]);
        }
        {
            float g[kPer][kPer];
#pragma unroll
            for (int r = 0; r < kPer; ++r)
#pragma unroll
                for (int c = 0; c < kPer; ++c) g[r][c] = 0.0f;
            for (int n = 0; n < N; ++n) {
                float cv[kPer], bv[kPer];
#pragma unroll
                for (int r = 0; r < kPer; ++r) {
                    const int i = ty + 16 * r;
                    cv[r] = i < l ? cs_[i * ns + n] : 0.0f;
                }
#pragma unroll
                for (int c = 0; c < kPer; ++c) {
                    const int j = tx + 16 * c;
                    bv[c] = j < l ? bs[j * ns + n] : 0.0f;
                }
#pragma unroll
                for (int r = 0; r < kPer; ++r)
#pragma unroll
                    for (int c = 0; c < kPer; ++c)
                        g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
            }
#pragma unroll
            for (int r = 0; r < kPer; ++r) {
                const int i = ty + 16 * r;
                if (i >= l) continue;
#pragma unroll
                for (int c = 0; c < kPer; ++c) {
                    const int j = tx + 16 * c;
                    if (j < l)
                        ms[i * lm + j] =
                            j <= i ? g[r][c] * expf(cum[i] - cum[j]) : 0.0f;
                }
            }
        }
        __syncthreads();

        // 4. y = exp(cs) (C S^T) + M x
        {
            float acc[kPer][kPN];
#pragma unroll
            for (int r = 0; r < kPer; ++r)
#pragma unroll
                for (int c = 0; c < kPN; ++c) acc[r][c] = 0.0f;
            for (int n = 0; n < N; ++n) {
                float cv[kPer], sv[kPN];
#pragma unroll
                for (int r = 0; r < kPer; ++r) {
                    const int i = ty + 16 * r;
                    cv[r] = i < l ? cs_[i * ns + n] : 0.0f;
                }
#pragma unroll
                for (int c = 0; c < kPN; ++c) {
                    const int p = tx + 16 * c;
                    sv[c] = p < P ? ss[p * ns + n] : 0.0f;
                }
#pragma unroll
                for (int r = 0; r < kPer; ++r)
#pragma unroll
                    for (int c = 0; c < kPN; ++c)
                        acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < kPer; ++r) {
                const int i = ty + 16 * r;
                const float e = i < l ? ecs[i] : 0.0f;
#pragma unroll
                for (int c = 0; c < kPN; ++c) acc[r][c] *= e;
            }
            for (int j = 0; j < l; ++j) {
                float mv[kPer], xv[kPN];
#pragma unroll
                for (int r = 0; r < kPer; ++r) {
                    const int i = ty + 16 * r;
                    mv[r] = i < l ? ms[i * lm + j] : 0.0f;
                }
#pragma unroll
                for (int c = 0; c < kPN; ++c) {
                    const int p = tx + 16 * c;
                    xv[c] = p < P ? xs[j * P + p] : 0.0f;
                }
#pragma unroll
                for (int r = 0; r < kPer; ++r)
#pragma unroll
                    for (int c = 0; c < kPN; ++c)
                        acc[r][c] = fmaf(mv[r], xv[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < kPer; ++r) {
                const int i = ty + 16 * r;
                if (i >= l) continue;
#pragma unroll
                for (int c = 0; c < kPN; ++c) {
                    const int p = tx + 16 * c;
                    if (p < P) yb[(int64_t)(t0 + i) * P + p] = acc[r][c];
                }
            }
        }
        __syncthreads();                 // every read of the old S is done

        // 5. S <- exp(cs_last) S + sum_j exp(cs_last - cs_j) x_j (x) B_j
        {
            float acc[kPN][kPN];
#pragma unroll
            for (int r = 0; r < kPN; ++r)
#pragma unroll
                for (int c = 0; c < kPN; ++c) acc[r][c] = 0.0f;
            for (int j = 0; j < l; ++j) {
                const float w = wdec[j];
                float xv[kPN], bv[kPN];
#pragma unroll
                for (int r = 0; r < kPN; ++r) {
                    const int p = ty + 16 * r;
                    xv[r] = p < P ? xs[j * P + p] * w : 0.0f;
                }
#pragma unroll
                for (int c = 0; c < kPN; ++c) {
                    const int n = tx + 16 * c;
                    bv[c] = n < N ? bs[j * ns + n] : 0.0f;
                }
#pragma unroll
                for (int r = 0; r < kPN; ++r)
#pragma unroll
                    for (int c = 0; c < kPN; ++c)
                        acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
            }
            const float decay = expf(cs_last);
#pragma unroll
            for (int r = 0; r < kPN; ++r) {
                const int p = ty + 16 * r;
                if (p >= P) continue;
#pragma unroll
                for (int c = 0; c < kPN; ++c) {
                    const int n = tx + 16 * c;
                    if (n < N)
                        ss[p * ns + n] = fmaf(decay, ss[p * ns + n], acc[r][c]);
                }
            }
        }
    }
}

size_t smem_bytes(int l, int P, int N) {
    const size_t ns = N | 1;
    return sizeof(float) * ((size_t)l * P + 2 * (size_t)l * ns +
                            (size_t)l * (l + 1) + (size_t)P * ns + 3 * (size_t)l);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers
// of contiguous float32 tensors xdt (B,H,S,P), a (B,H,S), Bm and Cm
// (B,S,N), y (B,H,S,P). 1 <= l, P, N <= 128 and S % l == 0. Launches on
// `stream` and returns cudaGetLastError() as an int (a launch the card
// refuses, for example for its shared memory, never runs and reports
// here).
extern "C" int ssd_scan_launch(const float* xdt, const float* a,
                               const float* Bm, const float* Cm, float* y,
                               int B, int H, int S, int P, int N, int l,
                               void* stream) {
    if (l < 1 || l > kMax || P < 1 || P > kMax || N < 1 || N > kMax ||
        S % l != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = smem_bytes(l, P, N);
    auto kernel = (P <= 64 && N <= 64) ? ssd_scan_kernel<4>
                                       : ssd_scan_kernel<kPer>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
        cudaGetLastError();  // clear it: the next launch must not report it
        return static_cast<int>(err);
    }
    const dim3 grid(H, B);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        xdt, a, Bm, Cm, y, H, S, P, N, l);
    return static_cast<int>(cudaGetLastError());
}
