// Segmented sum and max over unsorted segment ids, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_seg_kernel` reached through
// `segment_sum_pallas` / `segment_max_pallas` in
// src/repro/kernels/segment_reduce.py. For every segment s:
//
//   out[s] = sum (or max) of data[i] over the elements i with ids[i] == s
//
// with 0 (sum) or -inf (max) for a segment that no element names.
// Elements whose id lies outside [0, S) add the identity.
//
// Bound on this card: bytes. Each element is read once (4 B of data and
// 4 B of its place in the layout) for one add, far below the card's
// ratio of operations to bytes, so HBM bandwidth (3.35 TB/s on an H100
// SXM) sets the floor.
//
// Design. The TPU kernel builds a (128 segment x 128 element) one-hot
// matrix per grid step and reduces it on the matrix unit: O(E * S / 128)
// work, carried across a sequential grid axis, and a NaN or inf in one
// element spreads to every segment of its tile (0 * NaN = NaN). Here the
// wrapper first builds a CSR layout of the ids with exact integer work:
// `offsets` (S + 1) and `perm` (E), the valid element indices stably
// ordered by id, so segment s owns perm[offsets[s] .. offsets[s+1]) in
// ascending element order. Then one thread owns one segment and walks
// its list in that order, adding with one correctly rounded float add
// per element (__fadd_rn, never contracted into an FMA). The order of
// every sum is therefore fixed: the result is bitwise repeatable from
// run to run and bitwise equal to a sequential ascending-order float32
// sum, and a non-finite element stays in its own segment. No float
// atomics, no cross-block carry. The walk is unrolled by four: four
// indices, then four loads, then four adds in order, so each thread
// keeps four loads in flight without changing the order of the adds.
//
// For the (group, parameter) segments g * P + p of the tiered
// aggregation, every segment of a group has the same member list, so
// neighbouring threads (p, p + 1) walk in step and read neighbouring
// data addresses: the data loads coalesce. Each thread's own reads of
// `perm` are sequential, one 32 B sector serving eight steps.
//
// Max is order-free, with NaN propagating as in torch.amax and
// jax.ops.segment_max; it equals the plain PyTorch version exactly.
// A warp per segment for very wide segments, and building the layout
// in a kernel of its own, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename Op>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ data,
                      const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ offsets,
                      float* __restrict__ out, int32_t num_segments) {
    const int32_t s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= num_segments) return;
    const int32_t hi = offsets[s + 1];
    int32_t k = offsets[s];
    float acc = Op::identity();
    for (; k + 4 <= hi; k += 4) {
        const int32_t i0 = perm[k], i1 = perm[k + 1];
        const int32_t i2 = perm[k + 2], i3 = perm[k + 3];
        const float x0 = data[i0], x1 = data[i1];
        const float x2 = data[i2], x3 = data[i3];
        acc = Op::apply(acc, x0);
        acc = Op::apply(acc, x1);
        acc = Op::apply(acc, x2);
        acc = Op::apply(acc, x3);
    }
    for (; k < hi; ++k) acc = Op::apply(acc, data[perm[k]]);
    out[s] = acc;
}

template <typename Op>
int launch(const float* data, const int32_t* perm, const int32_t* offsets,
           float* out, int num_segments, void* stream) {
    const dim3 grid((num_segments + kThreads - 1) / kThreads);
    segment_reduce_kernel<Op><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        data, perm, offsets, out, num_segments);
    return static_cast<int>(cudaGetLastError());
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
