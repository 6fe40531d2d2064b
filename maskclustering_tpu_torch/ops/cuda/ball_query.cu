// Fixed-radius first-K neighbour search (ball query) for Hopper (sm_90a).
//
// Replaces the TPU kernel maskclustering_tpu/ops/pallas/ball_query.py
// (`_kernel`, :36-83, reached through `pl.pallas_call` in
// `ball_query_pallas`, :127) with the same contract, pytorch3d
// ball_query(return_nn=False): for each valid query row b, p
// (p < min(query_lengths[b], P)) the indices of the FIRST k candidates s
// (s < min(candidate_lengths[b], S)) in ascending index order with
//     d2 = (qx-cx)^2 + (qy-cy)^2 + (qz-cz)^2 <= r2,
// all in float32 and in that order. Unused slots and invalid rows stay -1:
// the caller pre-fills `out` with -1.
//
// Bound on this card: operations. Every valid row tests every candidate up
// to its k-th hit, 9 FP32 operations per pair test, and reads 12 bytes per
// candidate, which a block shares through shared memory. Bit-equality
// forbids fused multiply-adds (built with -fmad=false as well as the _rn
// intrinsics below, and the |q|^2 + |c|^2 - 2 q.c product form rounds
// differently), so the card issues at most 128 separate FP32 operations per
// SM and clock: half of the published FP32 peak, which counts an FMA as two.
// 50 % of the bound against that peak is this kernel's ceiling.
//
// Design. What held back a one-thread-per-row kernel: the query rows were
// the only parallel axis, so a large group filled 4 of an SM's 64 warp
// slots; each warp walked every candidate in series, 3 dependent shared
// loads and ~10 dependent operations per pair with nothing to hide their
// latency; and tiles were staged with stride-3 global loads behind a full
// barrier. At the scene's density (about 5 hits in a 1 cm ball, k = 20) no
// row ever fills, so the early exit never fires and every row scans every
// candidate. This kernel instead:
//
// - splits the candidate axis across the 32 lanes of a warp. A warp owns
//   ROWS_PER_WARP query rows, held as warp-uniform registers. In one step
//   of STEP = 128 candidates, lane l reads candidates 4 l .. 4 l + 3 of the
//   step with three 16-byte shared loads (a 48-byte lane stride, free of
//   bank conflicts) and tests each against every row: 16 independent pair
//   tests a lane, and one load serves ROWS_PER_WARP rows;
// - ranks hits with warp votes. The usual step has no hit for any row and
//   costs, beside its 9 operations per pair, one vote and one branch for
//   the whole warp. A step with a hit takes, for each row that has one,
//   m_j = ballot(hit on the lane's j-th candidate), j = 0..3: a hit goes to
//   slot count + (hits of lower lanes, the sum of popc(m_j & lanes below))
//   + (the lane's own earlier hits) if that is below k; then count += the
//   sum of popc(m_j). This is exact first-k in index order, also for a row
//   that reaches k in the middle of a step;
// - gives a block WARPS = 4 warps of one batch element, 16 rows: the
//   largest group of the full-size scene gets 1,089 blocks, of which its
//   36 KB of shared memory lets 6 share an SM;
// - streams the candidates through a ring of STAGES shared-memory tiles of
//   TILE candidates, each filled by one TMA bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx) that thread 0 issues; the
//   warps wait on the tile's mbarrier. The next STAGES - 1 tiles are in
//   flight while one is scanned. The one block barrier per tile
//   (__syncthreads_or) frees the tile for its next copy and stops the block
//   once every row is full;
// - stops a warp early when all its valid rows hold k hits (invalid rows
//   start full), and the block when every warp has stopped; copies still in
//   flight are waited for before the block exits.
//
// The bulk copies need 16-byte aligned sources and sizes: the wrapper
// passes S % 4 == 0 and a 16-byte aligned `cand`, so every tile starts at a
// multiple of 4 candidates (48 bytes) and the last tile's size, rounded up
// to 4 candidates, stays inside the allocation.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int BLOCK_ROWS = WARPS * ROWS_PER_WARP;
constexpr int STEP = 128;   // candidates a warp tests in one step, 4 a lane
constexpr int TILE = 1024;  // candidates per shared-memory tile
constexpr int STAGES = 3;
constexpr int TILE_FLOATS = TILE * 3;
constexpr int SMEM_BYTES = STAGES * TILE_FLOATS * static_cast<int>(sizeof(float));

static_assert(TILE % STEP == 0, "a tile is whole warp steps");
static_assert((TILE_FLOATS * sizeof(float)) % 16 == 0, "tiles must stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    }
}

// one TMA bulk copy of `bytes` from global to shared memory; completion is
// counted on `bar`, which expects that many bytes
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
    // the tile was last read through the generic proxy; order that before
    // the async proxy's write
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__global__ void __launch_bounds__(THREADS)
ball_query_kernel(const float* __restrict__ query,       // (B, P, 3)
                  const float* __restrict__ cand,        // (B, S, 3), S % 4 == 0
                  const int* __restrict__ query_lengths, // (B,)
                  const int* __restrict__ cand_lengths,  // (B,)
                  int P, int S, int K, float r2,
                  int* __restrict__ out) {               // (B, P, K), -1 filled
    extern __shared__ __align__(128) float tiles[];      // STAGES x TILE x 3
    __shared__ __align__(8) uint64_t full[STAGES];

    const int b = blockIdx.y;
    const int qlen = min(query_lengths[b], P);
    const int clen = min(cand_lengths[b], S);
    const int row0 = blockIdx.x * BLOCK_ROWS;
    if (row0 >= qlen || clen <= 0) return;  // block-uniform: nothing to find

    const float* c = cand + static_cast<int64_t>(b) * S * 3;
    const int n_tiles = (clen + TILE - 1) / TILE;
    auto issue = [&](int t) {
        const int first = t * TILE;
        const int n4 = (min(TILE, clen - first) + 3) & ~3;
        bulk_load(tiles + (t % STAGES) * TILE_FLOATS, c + static_cast<int64_t>(first) * 3,
                  static_cast<uint32_t>(n4 * 3 * sizeof(float)), &full[t % STAGES]);
    };
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int t = 0; t < min(STAGES, n_tiles); ++t) issue(t);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int prow0 = row0 + (threadIdx.x >> 5) * ROWS_PER_WARP;
    const uint32_t below = (1u << lane) - 1u;  // lanes under this one

    // warp-uniform rows; an invalid row starts full, so it never writes
    float qx[ROWS_PER_WARP], qy[ROWS_PER_WARP], qz[ROWS_PER_WARP];
    int count[ROWS_PER_WARP];
    bool active = false;
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int p = prow0 + r;
        qx[r] = qy[r] = qz[r] = 0.f;
        count[r] = K;
        if (p < qlen) {
            const float* q = query + (static_cast<int64_t>(b) * P + p) * 3;
            qx[r] = q[0];
            qy[r] = q[1];
            qz[r] = q[2];
            count[r] = 0;
            active = true;
        }
    }

    // one step of STEP candidates: lane l tests the 4 consecutive candidates
    // first + 4 l .. first + 4 l + 3 (12 floats, three 16-byte loads at
    // `cp`) against every row of the warp; a tail step masks candidates
    // past the candidate length (`tail`, a compile-time std::bool_constant)
    auto step = [&](const float* cp, int first, auto tail) {
        const float4 v0 = reinterpret_cast<const float4*>(cp)[0];
        const float4 v1 = reinterpret_cast<const float4*>(cp)[1];
        const float4 v2 = reinterpret_cast<const float4*>(cp)[2];
        const float cx[4] = {v0.x, v0.w, v1.z, v2.y};
        const float cy[4] = {v0.y, v1.x, v1.w, v2.z};
        const float cz[4] = {v0.z, v1.y, v2.x, v2.w};
        const int idx0 = first + 4 * lane;
        auto hit = [&](int r, int j) {
            const float dx = __fsub_rn(qx[r], cx[j]);
            const float dy = __fsub_rn(qy[r], cy[j]);
            const float dz = __fsub_rn(qz[r], cz[j]);
            const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                       __fmul_rn(dz, dz));
            return (d2 <= r2) & (!decltype(tail)::value || idx0 + j < clen);
        };
        bool row_any[ROWS_PER_WARP];
        bool any = false;
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
            row_any[r] = hit(r, 0) | hit(r, 1) | hit(r, 2) | hit(r, 3);
            any |= row_any[r];
        }
        if (!__any_sync(0xffffffffu, any)) return;  // no hit for any row: the usual step
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
            // warp-uniform: skip full rows and rows with no hit in the step
            if (count[r] >= K || !__any_sync(0xffffffffu, row_any[r])) continue;
            // rank: the hits of lower lanes (lower indices), then this
            // lane's own hits in index order
            bool h[4];
            int lower = 0, total = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                h[j] = hit(r, j);
                const uint32_t m = __ballot_sync(0xffffffffu, h[j]);
                lower += __popc(m & below);
                total += __popc(m);
            }
            int slot = count[r] + lower;
            int* row = out + (static_cast<int64_t>(b) * P + prow0 + r) * K;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (h[j]) {
                    if (slot < K) row[slot] = idx0 + j;
                    ++slot;
                }
            }
            count[r] += total;
        }
        active = false;
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) active |= count[r] < K;
    };

    int t = 0;
    for (; t < n_tiles; ++t) {
        if (active) {
            mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
            const float* tile = tiles + (t % STAGES) * TILE_FLOATS + 12 * lane;
            const int first = t * TILE;
            const int n = min(TILE, clen - first);
            const int steps = n / STEP;
#pragma unroll 2
            for (int j = 0; j < steps && active; ++j)
                step(tile + j * STEP * 3, first + j * STEP, std::false_type{});
            if (active && n % STEP)
                step(tile + steps * STEP * 3, first + steps * STEP, std::true_type{});
        }
        // every warp is past tile t: its buffer may take tile t + STAGES
        if (!__syncthreads_or(active)) break;
        if (threadIdx.x == 0 && t + STAGES < n_tiles) issue(t + STAGES);
    }
    // the copies issued but never waited for must land before the block's
    // shared memory is handed to another block
    if (threadIdx.x == 0) {
        const int issued = min(n_tiles, t + STAGES);
        for (int u = t + 1; u < issued; ++u) mbar_wait(&full[u % STAGES], (u / STAGES) & 1);
    }
}

}  // namespace

// Launches on card `device`, the ordinal of the tensors' card: this library
// links its own CUDA runtime, whose current device is set per host thread.
extern "C" int mc_ball_query(const float* query, const float* cand,
                             const int* query_lengths, const int* cand_lengths,
                             int B, int P, int S, int K, float r2, int* out,
                             int device, void* stream) {
    if (B <= 0 || P <= 0) return 0;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    if (SMEM_BYTES > 48 * 1024) {  // above the default limit only on request
        const cudaError_t err = cudaFuncSetAttribute(
            ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((P + BLOCK_ROWS - 1) / BLOCK_ROWS, B);
    ball_query_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        query, cand, query_lengths, cand_lengths, P, S, K, r2, out);
    return static_cast<int>(cudaGetLastError());
}
