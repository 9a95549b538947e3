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
// Bound on this card: bytes. Each (t, i, j) entry needs 1 B of adj, and
// 4 B of c_link only where the link is live, for one add and one
// compare: far below the card's ratio of operations to bytes, so HBM
// bandwidth (3.35 TB/s on an H100 SXM) sets the floor. DRAM moves
// 32-byte sectors, so the floor this design can reach is all of adj
// plus every 32-B sector of c_link that holds a live link (at density
// 0.1, 1 - 0.9^8 = 57% of them). On an H100 its time follows 64-byte
// granules instead (1 - 0.9^16 = 81% of them at density 0.1) at the
// ~2.4 TB/s this kernel reaches where every link is live.
//
// Design. The TPU kernel streams (bn x bn) tiles through VMEM and
// carries a running (min, argmin) per row across the sequential column
// grid axis. Blocks on Hopper run in no order, so nothing is carried
// between them: one warp owns one row and walks its columns itself.
// What limits a warp that walks a row one byte per lane and step is
// latency (each adj load, then the c_link load that depends on it), so:
//
// - adj is read as 16-byte vectors: a lane owns runs of kColsPerLane = 16
//   contiguous columns, one warp step covers 512 columns;
// - c_link is read as float4, and only for the 4-byte words of adj that
//   are non-zero: a sector with no live link is never fetched;
// - a step's loads are all in flight before its first compare: the adj
//   vector, then the c_link float4 of every live word of it. Two steps
//   could go together, but registers bound the warps in flight: one
//   step a thread holds 48 registers (5 blocks, 40 warps an SM), two
//   hold 72 (3 blocks), and on an H100 the first is 10% faster at the
//   fog-scale inputs;
// - a block's rows all belong to one round at a time, and c_next[t] is
//   staged in shared memory once per block and round, at index
//   j + j/16 so that the 32 lanes of a step (16 columns apart) hit 32
//   different banks. Above kStageMaxBytes (n > 11566) the rows read
//   c_next through the read-only cache instead: a row then reads
//   n floats of c_link against at most n of c_next, which stay in L2;
// - the grid is persistent: as many blocks as fit on the card at once,
//   each taking an equal contiguous range of the T*n rows, so there is
//   no tail of a last partial wave. The SM count and the occupancy are
//   asked of the runtime once per device and shared-memory size and
//   kept: asked at every launch, they added host time to every call.
//
// A row starts at byte (t*n+i)*n of adj, so for n not a multiple of 16
// most rows are not aligned for vector loads. Each row peels a head of
// h < 16 columns up to adj's next 16-byte boundary and a tail of fewer
// than 16 after its last whole run; lane L takes head column L and tail
// column L, scalar. The c_link vector of a run is 16-byte aligned too
// when c_link's and adj's base addresses agree: c_link - 4*adj is a
// multiple of 16, true for any two fresh allocations. The entry point
// refuses other bases (the PyTorch wrapper copies such a view first).
// Nothing is read outside [0, n) of the row.
//
// Each lane scans its own columns in ascending j (head, runs, tail)
// with a strict <, and the warp reduces the (min, argmin) pairs with
// shuffles under (v < v') || (v == v' && j < j'), so the lowest-j rule
// holds whatever the lane layout. Masked entries never enter the
// compare (the TPU kernel writes 3.4e38 instead of +inf). The adds are
// single correctly rounded float adds (__fadd_rn) and min is order-free,
// so the result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps a block, one row a warp
constexpr int kColsPerLane = 16;     // one uint4 of adj a lane and step
constexpr int kStageMaxBytes = 48 * 1024;

// shared-memory index of c_next[j]: one pad word after every 16
__device__ __forceinline__ int staged(int j) { return j + (j >> 4); }

struct Best {
    float v;
    int j;
};

template <bool kStage>
__device__ __forceinline__ void consider(Best& b, int j, int i, float link,
                                         const float* cn_s,
                                         const float* cn_g) {
    if (j == i) return;
    const float nxt = kStage ? cn_s[staged(j)] : __ldg(cn_g + j);
    const float e = __fadd_rn(link, nxt);
    if (e < b.v) {
        b.v = e;
        b.j = j;
    }
}

// One row, walked by one warp; lane 0 writes the row's results.
template <bool kStage>
__device__ __forceinline__ void decide_row(
        const float* __restrict__ c_link, const float* __restrict__ c_node,
        const float* __restrict__ f_err, const uint8_t* __restrict__ adj,
        int32_t* __restrict__ choice, int32_t* __restrict__ best_j,
        float* __restrict__ best_cost, long long r, int i, int n,
        const float* cn_s, const float* cn_g, int lane) {
    const size_t off = static_cast<size_t>(r) * static_cast<size_t>(n);
    const uint8_t* ad = adj + off;
    const float* cl = c_link + off;
    const int h = min(n, static_cast<int>(
        (16u - (reinterpret_cast<uintptr_t>(ad) & 15u)) & 15u));
    const int runs = (n - h) / kColsPerLane;
    const int tail = h + runs * kColsPerLane;

    // head and tail: at most one column each a lane
    const int jt = tail + lane;
    const bool head_live = lane < h && __ldg(ad + lane) != 0;
    const bool tail_live = jt < n && __ldg(ad + jt) != 0;
    const float head_link = head_live ? __ldg(cl + lane) : 0.f;
    const float tail_link = tail_live ? __ldg(cl + jt) : 0.f;

    Best b{__int_as_float(0x7f800000), 0};   // (+inf, 0)
    if (head_live) consider<kStage>(b, lane, i, head_link, cn_s, cn_g);

    const uint4* av = reinterpret_cast<const uint4*>(ad + h);
    const float* cb = cl + h;
    for (int s = 0; s < runs; s += 32) {
        const int run = s + lane;
        const uint4 a = run < runs ? __ldg(av + run)
                                   : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t w[4] = {a.x, a.y, a.z, a.w};
        const float* p = cb + static_cast<size_t>(run) * kColsPerLane;
        float4 f[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {       // every load of the step first
            f[q] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (w[q] != 0u)
                f[q] = __ldg(reinterpret_cast<const float4*>(p + 4 * q));
        }
        const int j0 = h + run * kColsPerLane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float x[4] = {f[q].x, f[q].y, f[q].z, f[q].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {   // byte k = column 4q + k
                if ((w[q] >> (8 * k)) & 0xffu)
                    consider<kStage>(b, j0 + 4 * q + k, i, x[k], cn_s, cn_g);
            }
        }
    }
    if (tail_live) consider<kStage>(b, jt, i, tail_link, cn_s, cn_g);

    // lanes that saw no finite candidate hold (+inf, 0): they lose to
    // any finite pair, and an all-empty row ends at (+inf, 0)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, b.v, o);
        const int oj = __shfl_xor_sync(0xffffffffu, b.j, o);
        if (ov < b.v || (ov == b.v && oj < b.j)) {
            b.v = ov;
            b.j = oj;
        }
    }
    if (lane == 0) {
        const float proc = c_node[r];
        const float disc = f_err[r];
        const float best = fminf(fminf(proc, b.v), disc);
        choice[r] = proc <= best ? 0 : (b.v <= best ? 1 : 2);
        best_j[r] = b.j;
        best_cost[r] = best;
    }
}

template <bool kStage>
__global__ void __launch_bounds__(kWarps * 32)
offload_greedy_kernel(const float* __restrict__ c_link,
                      const float* __restrict__ c_next,
                      const float* __restrict__ c_node,
                      const float* __restrict__ f_err,
                      const uint8_t* __restrict__ adj,
                      int32_t* __restrict__ choice,
                      int32_t* __restrict__ best_j,
                      float* __restrict__ best_cost, int T, int n) {
    extern __shared__ float cn_s[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // this block's rows of the flattened (t, i): an equal contiguous share
    const long long rows = static_cast<long long>(T) * n;
    long long lo = rows * blockIdx.x / gridDim.x;
    const long long hi = rows * (blockIdx.x + 1) / gridDim.x;
    while (lo < hi) {                       // one round at a time
        const int t = static_cast<int>(lo / n);
        const long long base = static_cast<long long>(t) * n;
        const long long end = min(hi, base + n);
        const float* cn_g = c_next + base;
        if (kStage) {
            __syncthreads();                // the last round's readers are done
            for (int j = threadIdx.x; j < n; j += kWarps * 32)
                cn_s[staged(j)] = cn_g[j];
            __syncthreads();
        }
        for (long long r = lo + warp; r < end; r += kWarps)
            decide_row<kStage>(c_link, c_node, f_err, adj, choice, best_j,
                               best_cost, r, static_cast<int>(r - base), n,
                               cn_s, cn_g, lane);
        lo = end;
    }
}

// Blocks of the kernel resident at once on the current device, for a
// block of `smem` bytes of shared memory. The runtime's answer is kept
// per device for the last size asked: asking at every launch would add
// its host time to every call.
template <bool kStage>
cudaError_t resident_blocks(int smem, long long* blocks) {
    struct Fit {
        int smem = -1;
        long long blocks = 0;
    };
    constexpr int kMaxDevices = 64;
    thread_local Fit fits[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    Fit* fit = dev < kMaxDevices ? &fits[dev] : nullptr;
    if (fit != nullptr && fit->smem == smem) {
        *blocks = fit->blocks;
        return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, offload_greedy_kernel<kStage>, kWarps * 32, smem);
    if (err != cudaSuccess) return err;
    *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    if (fit != nullptr) *fit = Fit{smem, *blocks};
    return cudaSuccess;
}

template <bool kStage>
int launch(const float* c_link, const float* c_next, const float* c_node,
           const float* f_err, const uint8_t* adj, int32_t* choice,
           int32_t* best_j, float* best_cost, int T, int n,
           cudaStream_t stream) {
    const int smem = kStage ? static_cast<int>(sizeof(float))
                                  * (n + (n >> 4)) : 0;
    long long fit = 0;
    const cudaError_t err = resident_blocks<kStage>(smem, &fit);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long rows = static_cast<long long>(T) * n;
    const long long want = (rows + kWarps - 1) / kWarps;
    const int grid = static_cast<int>(want < fit ? want : fit);
    offload_greedy_kernel<kStage><<<grid, kWarps * 32, smem, stream>>>(
        c_link, c_next, c_node, f_err, adj, choice, best_j, best_cost, T, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device
// pointers of contiguous tensors: c_link (T,n,n) f32, c_next, c_node,
// f_err (T,n) f32, adj (T,n,n) bool (one byte each), outputs (T,n);
// c_link - 4*adj a multiple of 16 bytes (else cudaErrorMisalignedAddress
// is returned and nothing launched). Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int offload_greedy_launch(const float* c_link, const float* c_next,
                                     const float* c_node, const float* f_err,
                                     const uint8_t* adj, int32_t* choice,
                                     int32_t* best_j, float* best_cost,
                                     int T, int n, void* stream) {
    if (T <= 0 || n <= 0) return 0;         // nothing to decide
    // a run's c_link float4 is 16-B aligned wherever its adj uint4 is
    if (((reinterpret_cast<uintptr_t>(c_link)
          - 4 * reinterpret_cast<uintptr_t>(adj)) & 15u) != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    const auto s = static_cast<cudaStream_t>(stream);
    if (static_cast<long long>(sizeof(float)) * (n + (n >> 4))
            <= kStageMaxBytes)
        return launch<true>(c_link, c_next, c_node, f_err, adj, choice,
                            best_j, best_cost, T, n, s);
    return launch<false>(c_link, c_next, c_node, f_err, adj, choice, best_j,
                         best_cost, T, n, s);
}
