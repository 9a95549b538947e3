// Segment reductions hand-written for Hopper: a sum or max over unsorted
// segment ids, and the row-segment sum of the tiered aggregation.
//
// Replaces the Pallas TPU kernel `_seg_kernel` reached through
// `segment_sum_pallas` / `segment_max_pallas` in
// src/repro/kernels/segment_reduce.py. For every segment s:
//
//   out[s] = sum (or max) of data[i] over the elements i with ids[i] == s
//
// with 0 (sum) or -inf (max) for a segment that no element names.
// Elements whose id lies outside [0, S) add the identity. The row form
// (`segment_sum_rows_launch`) sums (m, P) rows into (G, P) groups,
//
//   out[g, p] = sum over members i of g, ascending, of data[i, p] * h[i]
//
// with the scale h optional: the eq. (4) numerator of one tier in one
// pass over the parameters.
//
// Order. The wrapper builds a CSR layout of the ids with exact integer
// work: `offsets` (S + 1) and `perm` (E), the valid element indices
// stably ordered by id, so segment s owns perm[offsets[s] ..
// offsets[s+1]) in ascending element order. Every sum here starts from
// +0 and adds its elements in that order, one correctly rounded add
// each (__fadd_rn; the row form's product is __fmul_rn: neither is ever
// contracted into an FMA). The result is bitwise a sequential float32
// sum, repeatable from run to run, a non-finite element stays in its
// own segment, and the row form equals a multiply followed by the 1-D
// sum over the ids g * P + p bit for bit. No float atomics, no
// cross-block carry. Max is order-free (NaN propagates, as in
// torch.amax and jax.ops.segment_max) but walks the same order.
//
// Bound on this card: bytes. Each element is read once for one add (two
// for the row form with a scale), far below the card's ratio of
// operations to bytes, so HBM bandwidth (3.35 TB/s on an H100 SXM) sets
// the floor; a segment of k elements also needs k dependent adds (~4
// cycles each), which only a very long segment feels.
//
// Design of the 1-D kernel. A block owns 256 * K consecutive segments
// and stages their offsets in shared memory with coalesced reads; thread
// t owns the block's segments t, t + 256, ..., K of them (K, 1..8,
// chosen at launch so that the grid is about one full wave of the
// card). Lanes in step thus work on neighbouring segments, and where
// neighbouring segments own neighbouring elements (one-element cells of
// sorted keys, the ids g * P + p of a stacked leaf) their loads and
// stores coalesce. A thread sums its segments of at most K elements in
// lockstep: each step loads one element of each (K indices, then K data
// loads, all in flight) and then adds, so one-element segments (per-cell
// sample counts) keep K loads in flight per thread instead of three
// dependent ones. A longer segment is walked alone, eight elements a
// step (eight indices, then eight loads in flight, then eight adds). A
// segment longer than kWideMin elements is left out of the lone walk:
// the warp that owns it gathers it in chunks of 256 (each lane eight
// coalesced index loads and eight data loads, the next chunk's loads in
// flight while the current one is added), stages each chunk in shared
// memory, and lane 0 adds the chunk in ascending order: its time is
// then the chain of dependent adds, not a lone thread's loads.
//
// Design of the row kernel. One block per (group, tile of P); the
// threads run across p with the widest vector load that the row
// alignment allows (float4, float2 or float: the data base and P decide,
// every row then starts aligned). A block stages 256 member indices and
// their scales in shared memory at a time (each read once per block),
// then each thread walks the members in ascending order with 8 (float4)
// or 16 loads in flight before their adds. Row addresses are 64-bit. No
// (m, P) product and no E-length ids exist: the layout is of the m
// member ids only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSegsPerThread = 8;
constexpr int kUnroll = 8;              // lone walk: loads in flight a thread
constexpr int kStage = 8;               // warp walk: loads in flight a lane
constexpr int kChunk = 32 * kStage;     // elements a warp stages a step
constexpr int kRowMembers = 256;        // member indices staged a step
constexpr unsigned kFull = 0xffffffffu;
// longer segments take the warp walk: alone in its warp such a segment
// runs 20x faster so; where every lane of a warp has one (segments of
// ~4096) the warp's turns cost about as much as the lanes' lone walks.
// No tier or counts launch reaches it (groups of tens to hundreds of
// members, about one sample a cell); a generic segment_sum over a few
// long segments does, as aggregate_edges' P segments of its k listed
// devices when k > kWideMin.
constexpr int kWideMin = 2048;

struct SumOp {
    __device__ static float identity() { return 0.0f; }
    __device__ static float apply(float acc, float x) {
        return __fadd_rn(acc, x);
    }
};

struct MaxOp {
    __device__ static float identity() {
        return __int_as_float(0xff800000);  // -inf
    }
    // NaN propagates: once acc is NaN no compare replaces it
    __device__ static float apply(float acc, float x) {
        return (x > acc || x != x) ? x : acc;
    }
};

// One thread sums perm[lo..hi) alone, eight elements a step: eight
// indices, then eight data loads, all in flight, then eight adds. Out
// of line, as is warp_walk: inlined, their registers would count against
// the short segments' lockstep, whose speed is the kernel's occupancy.
template <typename Op>
__device__ __noinline__ float walk(const float* __restrict__ data,
                                      const int32_t* __restrict__ perm,
                                      int lo, int hi) {
    float acc = Op::identity();
    for (int k = lo; k < hi; k += kUnroll) {
        int32_t idx[kUnroll];
        float x[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
            idx[j] = k + j < hi ? perm[k + j] : 0;
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
            x[j] = k + j < hi ? data[idx[j]] : 0.0f;
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
            if (k + j < hi) acc = Op::apply(acc, x[j]);
    }
    return acc;
}

// The whole warp gathers perm[lo..hi) in chunks of kChunk; lane 0 adds
// each chunk in ascending order from the staging buffer `buf` while the
// next chunk's loads are in flight. The result is lane 0's.
template <typename Op>
__device__ __noinline__ float warp_walk(const float* __restrict__ data,
                           const int32_t* __restrict__ perm, int lo, int hi,
                           float* buf, int lane) {
    const int n = hi - lo;
    const int32_t* p = perm + lo;
    int32_t idx[kStage];
    float x[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
        const int k = j * 32 + lane;
        idx[j] = k < n ? p[k] : -1;
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) x[j] = idx[j] >= 0 ? data[idx[j]] : 0.0f;
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
        const int k = kChunk + j * 32 + lane;
        idx[j] = k < n ? p[k] : -1;
    }
    float acc = Op::identity();
    for (int base = 0; base < n; base += kChunk) {
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kStage; ++j) buf[j * 32 + lane] = x[j];
        __syncwarp();
        // the next chunk's data, and the indices of the one after it
#pragma unroll
        for (int j = 0; j < kStage; ++j)
            x[j] = idx[j] >= 0 ? data[idx[j]] : 0.0f;
#pragma unroll
        for (int j = 0; j < kStage; ++j) {
            const int k = base + 2 * kChunk + j * 32 + lane;
            idx[j] = k < n ? p[k] : -1;
        }
        if (lane == 0) {
            const int cnt = min(kChunk, n - base);
            if (cnt == kChunk) {
                const float4* b4 = reinterpret_cast<const float4*>(buf);
#pragma unroll 16
                for (int e = 0; e < kChunk / 4; ++e) {
                    const float4 v = b4[e];
                    acc = Op::apply(acc, v.x);
                    acc = Op::apply(acc, v.y);
                    acc = Op::apply(acc, v.z);
                    acc = Op::apply(acc, v.w);
                }
            } else {
                for (int e = 0; e < cnt; ++e) acc = Op::apply(acc, buf[e]);
            }
        }
    }
    return acc;
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ data,
                      const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ offsets,
                      float* __restrict__ out, int32_t num_segments,
                      int segs_per_thread) {
    extern __shared__ __align__(16) float smem[];
    float* stage = smem;                                  // kWarps * kChunk
    int32_t* so = reinterpret_cast<int32_t*>(smem + kWarps * kChunk);
    const int K = segs_per_thread;
    const int first = blockIdx.x * kThreads * K;
    const int cnt = min(kThreads * K, num_segments - first);
    for (int j = threadIdx.x; j <= cnt; j += kThreads)
        so[j] = offsets[first + j];
    __syncthreads();
    float* bout = out + first;
    // thread t owns the block's segments t, t + kThreads, ...: lanes in
    // step work on neighbouring segments, whose offsets (and, where
    // neighbouring segments own neighbouring elements, data) lie side
    // by side
    const int t = threadIdx.x;
    const int nseg = min(K, (cnt - t + kThreads - 1) / kThreads);
    int lo[kMaxSegsPerThread], len[kMaxSegsPerThread];
    int steps = 0;
    unsigned mid = 0, wide = 0;             // bit j: the j-th segment's walk
#pragma unroll
    for (int j = 0; j < kMaxSegsPerThread; ++j) {
        lo[j] = len[j] = 0;
        if (j < nseg) {
            const int s = t + j * kThreads;
            const int n = so[s + 1] - so[s];
            if (n <= K) {
                lo[j] = so[s];
                len[j] = n;
                steps = max(steps, n);
            } else if (n <= kWideMin) {
                mid |= 1u << j;
            } else {
                wide |= 1u << j;
            }
        }
    }
    // short segments (at most K elements) in lockstep: a step loads one
    // element of each, so their loads are all in flight before any add
    float acc[kMaxSegsPerThread];
#pragma unroll
    for (int j = 0; j < kMaxSegsPerThread; ++j) acc[j] = Op::identity();
    for (int r = 0; r < steps; ++r) {
        int32_t idx[kMaxSegsPerThread];
        float x[kMaxSegsPerThread];
#pragma unroll
        for (int j = 0; j < kMaxSegsPerThread; ++j)
            idx[j] = r < len[j] ? perm[lo[j] + r] : 0;
#pragma unroll
        for (int j = 0; j < kMaxSegsPerThread; ++j)
            x[j] = r < len[j] ? data[idx[j]] : 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxSegsPerThread; ++j)
            if (r < len[j]) acc[j] = Op::apply(acc[j], x[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxSegsPerThread; ++j)
        if (j < nseg && !((mid | wide) >> j & 1))
            bout[t + j * kThreads] = acc[j];
    // longer ones alone, eight loads in flight
    while (mid) {
        const int s = t + (__ffs(mid) - 1) * kThreads;
        mid &= mid - 1;
        bout[s] = walk<Op>(data, perm, so[s], so[s + 1]);
    }
    // the warp's wide segments, one after another, the whole warp on each
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float* buf = stage + warp * kChunk;
    unsigned owners = __ballot_sync(kFull, wide != 0);
    while (owners) {
        const int src = __ffs(owners) - 1;
        owners &= owners - 1;
        unsigned bits = __shfl_sync(kFull, wide, src);
        while (bits) {
            const int s = warp * 32 + src + (__ffs(bits) - 1) * kThreads;
            bits &= bits - 1;
            const float r = warp_walk<Op>(data, perm, so[s], so[s + 1], buf,
                                          lane);
            if (lane == 0) bout[s] = r;
        }
    }
}

// The card's SM count, kept per device: asking at every launch would add
// its host time to every call.
cudaError_t sm_count(int* sms) {
    constexpr int kMaxDevices = 64;
    thread_local int known[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && known[dev] > 0) {
        *sms = known[dev];
        return cudaSuccess;
    }
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < kMaxDevices) known[dev] = *sms;
    return err;
}

template <typename Op>
int launch(const float* data, const int32_t* perm, const int32_t* offsets,
           float* out, int num_segments, void* stream) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    // as many segments a thread as make the grid one wave of 2048
    // threads an SM, from 1 to kMaxSegsPerThread
    const long long wave = 2048LL * sms;
    long long K = (num_segments + wave - 1) / wave;
    K = K < 1 ? 1 : (K > kMaxSegsPerThread ? kMaxSegsPerThread : K);
    const long long per_block = kThreads * K;
    const dim3 grid(static_cast<unsigned>(
        (num_segments + per_block - 1) / per_block));
    const size_t smem = sizeof(float) * kWarps * kChunk
                        + sizeof(int32_t) * (per_block + 1);
    segment_reduce_kernel<Op><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        data, perm, offsets, out, num_segments, static_cast<int>(K));
    return static_cast<int>(cudaGetLastError());
}

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void split(float v, float* o) { o[0] = v; }
__device__ __forceinline__ void split(float2 v, float* o) {
    o[0] = v.x;
    o[1] = v.y;
}
__device__ __forceinline__ void split(float4 v, float* o) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
}
__device__ __forceinline__ void join(const float* a, float* o) { *o = a[0]; }
__device__ __forceinline__ void join(const float* a, float2* o) {
    *o = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void join(const float* a, float4* o) {
    *o = make_float4(a[0], a[1], a[2], a[3]);
}

template <int VEC, bool kScale>
__global__ void __launch_bounds__(kThreads)
segment_rows_kernel(const float* __restrict__ data,
                    const float* __restrict__ scale,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ offsets,
                    float* __restrict__ out, long long row_vecs, int nvec,
                    int tiles) {
    constexpr int U = VEC == 4 ? 8 : 16;    // member loads in flight
    using V = typename Vec<VEC>::T;
    __shared__ int32_t s_idx[kRowMembers];
    __shared__ float s_h[kRowMembers];
    const int g = blockIdx.x / tiles;
    const int c = (blockIdx.x - g * tiles) * blockDim.x + threadIdx.x;
    const bool active = c < nvec;
    const int lo = offsets[g], hi = offsets[g + 1];
    const V* col = reinterpret_cast<const V*>(data) + c;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
    for (int base = lo; base < hi; base += kRowMembers) {
        const int n = min(kRowMembers, hi - base);
        __syncthreads();
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            const int32_t i = perm[base + j];
            s_idx[j] = i;
            if (kScale) s_h[j] = scale[i];
        }
        __syncthreads();
        if (!active) continue;
        for (int k = 0; k < n; k += U) {
            V x[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (k + u < n)
                    x[u] = col[static_cast<long long>(s_idx[k + u])
                               * row_vecs];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (k + u < n) {
                    float xs[VEC];
                    split(x[u], xs);
#pragma unroll
                    for (int q = 0; q < VEC; ++q)
                        acc[q] = kScale
                            ? __fadd_rn(acc[q], __fmul_rn(xs[q], s_h[k + u]))
                            : __fadd_rn(acc[q], xs[q]);
                }
            }
        }
    }
    if (active) {
        V o;
        join(acc, &o);
        reinterpret_cast<V*>(out)[static_cast<long long>(g) * row_vecs + c] =
            o;
    }
}

template <int VEC, bool kScale>
int launch_rows(const float* data, const float* scale, const int32_t* perm,
                const int32_t* offsets, float* out, int num_groups,
                long long P, void* stream) {
    const long long nvec = P / VEC;
    const long long threads = ((nvec + 31) / 32) * 32 < kThreads
                              ? ((nvec + 31) / 32) * 32 : kThreads;
    const long long tiles = (nvec + threads - 1) / threads;
    if (nvec > 0x7fffffffLL || tiles * num_groups > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    segment_rows_kernel<VEC, kScale>
        <<<static_cast<unsigned>(tiles * num_groups),
           static_cast<unsigned>(threads), 0,
           static_cast<cudaStream_t>(stream)>>>(
            data, scale, perm, offsets, out, nvec, static_cast<int>(nvec),
            static_cast<int>(tiles));
    return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool kScale>
int rows_by_width(const float* data, const float* scale, const int32_t* perm,
                  const int32_t* offsets, float* out, int num_groups,
                  long long P, void* stream) {
    // the widest load at which every row of data and out starts aligned
    if (P % 4 == 0 && aligned(data, 16) && aligned(out, 16))
        return launch_rows<4, kScale>(data, scale, perm, offsets, out,
                                      num_groups, P, stream);
    if (P % 2 == 0 && aligned(data, 8) && aligned(out, 8))
        return launch_rows<2, kScale>(data, scale, perm, offsets, out,
                                      num_groups, P, stream);
    return launch_rows<1, kScale>(data, scale, perm, offsets, out,
                                  num_groups, P, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes. All pointers are device
// pointers of contiguous tensors: data (E,) f32, perm (E,) int32 (its
// first offsets[S] entries are read), offsets (S + 1,) int32, out (S,)
// f32. num_segments >= 1. Each launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int segment_sum_launch(const float* data, const int32_t* perm,
                                  const int32_t* offsets, float* out,
                                  int num_segments, void* stream) {
    return launch<SumOp>(data, perm, offsets, out, num_segments, stream);
}

extern "C" int segment_max_launch(const float* data, const int32_t* perm,
                                  const int32_t* offsets, float* out,
                                  int num_segments, void* stream) {
    return launch<MaxOp>(data, perm, offsets, out, num_segments, stream);
}

// The row form: data (m, P) f32, scale (m,) f32 or null, perm (m,) and
// offsets (G + 1,) int32 (the layout of the m member ids), out (G, P)
// f32. num_groups >= 1, P >= 1; returns cudaErrorInvalidValue (launching
// nothing) where the grid would not fit.
extern "C" int segment_sum_rows_launch(const float* data, const float* scale,
                                       const int32_t* perm,
                                       const int32_t* offsets, float* out,
                                       int num_groups, long long P,
                                       void* stream) {
    if (scale != nullptr)
        return rows_by_width<true>(data, scale, perm, offsets, out,
                                   num_groups, P, stream);
    return rows_by_width<false>(data, scale, perm, offsets, out, num_groups,
                                P, stream);
}
