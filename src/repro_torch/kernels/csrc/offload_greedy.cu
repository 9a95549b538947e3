// Theorem-3 offload decision for all T rounds, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` reached through
// `offload_greedy` / `offload_greedy_batched` / `offload_greedy_edges`
// in src/repro/kernels/offload_greedy.py. For every round t and row i:
//
//   best_j[t,i] = argmin_{j : adj[t,i,j], j != i} c_link[t,i,j] + c_next[t,j]
//                 (lowest j on equal cost; 0 when no j qualifies)
//   off         = that minimum (+inf when no j qualifies)
//   best_cost   = min(c_node[t,i], off, f_err[t,i])
//   choice      = 0 process / 1 offload / 2 discard, ties resolved
//                 process < offload < discard
//
// Bound on this card: bytes. Each (t, i, j) entry is read once (4 B of
// c_link, 1 B of adj) for one add and one compare, so the kernel moves
// T*n*n*5 B against 2*T*n*n operations: far below the card's ratio of
// operations to bytes, so HBM bandwidth (3.35 TB/s on an H100 SXM) sets
// the floor.
//
// Design. The TPU kernel streams (bn x bn) tiles through VMEM and
// carries a running (min, argmin) per row across the sequential column
// grid axis. Blocks on Hopper run in no order, so nothing is carried
// between them: instead one warp owns one row and walks its columns
// itself. Its lanes stride over j, so each step reads 32 consecutive
// floats of c_link (one 128 B line), 32 bytes of adj and 32 floats of
// c_next, all coalesced; nothing is staged in shared memory because no
// entry is reused. Each lane keeps a running (min, argmin) updated with
// strict < over ascending j, and the warp reduces the pairs with
// shuffles under (v < v') || (v == v' && j < j'), which keeps the
// lowest-j rule that best_j must match exactly. Masked entries never
// enter the compare (the TPU kernel writes 3.4e38 instead of +inf), and
// the loop bound masks the ragged last row tile, so any n >= 1 works.
// The adds are single correctly rounded float adds (__fadd_rn), and min
// is order-free, so the result equals the plain PyTorch version bit for
// bit. Vector loads, multi-row tiles and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
offload_greedy_kernel(const float* __restrict__ c_link,
                      const float* __restrict__ c_next,
                      const float* __restrict__ c_node,
                      const float* __restrict__ f_err,
                      const uint8_t* __restrict__ adj,
                      int32_t* __restrict__ choice,
                      int32_t* __restrict__ best_j,
                      float* __restrict__ best_cost,
                      int n) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int t = blockIdx.y;
    if (i >= n) return;                    // whole warp leaves together

    const size_t vec = static_cast<size_t>(t) * n;
    const size_t row = (vec + i) * static_cast<size_t>(n);
    const float* cl = c_link + row;
    const uint8_t* ad = adj + row;
    const float* cn = c_next + vec;

    float v = __int_as_float(0x7f800000);  // +inf
    int arg = 0;
    for (int j = lane; j < n; j += 32) {
        if (ad[j] && j != i) {
            const float e = __fadd_rn(cl[j], cn[j]);
            if (e < v) {
                v = e;
                arg = j;
            }
        }
    }
    // lanes that saw no finite candidate hold (+inf, 0): they lose to
    // any finite pair, and an all-empty row ends at (+inf, 0)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ov < v || (ov == v && oa < arg)) {
            v = ov;
            arg = oa;
        }
    }
    if (lane == 0) {
        const float proc = c_node[vec + i];
        const float disc = f_err[vec + i];
        const float best = fminf(fminf(proc, v), disc);
        choice[vec + i] = proc <= best ? 0 : (v <= best ? 1 : 2);
        best_j[vec + i] = arg;
        best_cost[vec + i] = best;
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device
// pointers of contiguous tensors: c_link (T,n,n) f32, c_next, c_node,
// f_err (T,n) f32, adj (T,n,n) bool (one byte each), outputs (T,n).
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int offload_greedy_launch(const float* c_link, const float* c_next,
                                     const float* c_node, const float* f_err,
                                     const uint8_t* adj, int32_t* choice,
                                     int32_t* best_j, float* best_cost,
                                     int T, int n, void* stream) {
    const dim3 block(kWarpsPerBlock * 32);
    const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, T);
    offload_greedy_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        c_link, c_next, c_node, f_err, adj, choice, best_j, best_cost, n);
    return static_cast<int>(cudaGetLastError());
}
