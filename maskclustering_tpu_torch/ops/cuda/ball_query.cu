// Fixed-radius first-K neighbour search (ball query) for Hopper (sm_90a).
//
// Replaces the TPU kernel maskclustering_tpu/ops/pallas/ball_query.py
// (`_kernel`, :36-83, launched by `ball_query_pallas`, :91-152) with the same
// contract, pytorch3d ball_query(return_nn=False): for each valid query row
// b, p (p < query_lengths[b]) the indices of the FIRST k candidates s
// (s < candidate_lengths[b]) in ascending index order with
//     d2 = (qx-cx)^2 + (qy-cy)^2 + (qz-cz)^2 <= r2,
// all in float32 and in that order. Unused slots and invalid rows stay -1:
// the caller pre-fills `out` with -1.
//
// Bound on this card: operations. Every valid row tests every candidate up
// to its k-th hit (about 9 FP32 operations per pair test) and reads only
// 12 bytes per candidate, which the block shares through shared memory, so
// the FP32 rate bounds it long before the 3.35 TB/s of device memory.
//
// Design: one thread per query row, a block of QUERY_TILE rows of one batch
// element. The block stages candidate tiles of CAND_TILE points in shared
// memory (structure of arrays, no bank conflicts on the broadcast reads);
// each thread scans the tile in index order, writes hit s to slot count++
// and stops at count == k. The block stops loading tiles once every row is
// full (__syncthreads_or), which is also the barrier that protects the tile
// before it is overwritten. The TPU kernel's triangular-matmul prefix sum
// and one-hot slot sum exist only because Mosaic has no cumsum or scatter;
// a thread's own running count replaces both.
//
// Build with -fmad=false as well: the intrinsics below already forbid
// contraction, and a fused multiply-add would flip hits on the boundary
// against the plain torch version.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int QUERY_TILE = 128;
constexpr int CAND_TILE = 256;

__global__ void __launch_bounds__(QUERY_TILE)
ball_query_kernel(const float* __restrict__ query,       // (B, P, 3)
                  const float* __restrict__ cand,        // (B, S, 3)
                  const int* __restrict__ query_lengths, // (B,)
                  const int* __restrict__ cand_lengths,  // (B,)
                  int P, int S, int K, float r2,
                  int* __restrict__ out) {               // (B, P, K), -1 filled
    __shared__ float sx[CAND_TILE];
    __shared__ float sy[CAND_TILE];
    __shared__ float sz[CAND_TILE];

    const int b = blockIdx.y;
    const int p = blockIdx.x * QUERY_TILE + threadIdx.x;
    const int qlen = min(query_lengths[b], P);
    const int clen = min(cand_lengths[b], S);
    const bool valid = p < qlen;

    float qx = 0.f, qy = 0.f, qz = 0.f;
    int* row = nullptr;
    if (valid) {
        const float* q = query + (static_cast<int64_t>(b) * P + p) * 3;
        qx = q[0];
        qy = q[1];
        qz = q[2];
        row = out + (static_cast<int64_t>(b) * P + p) * K;
    }
    const float* c = cand + static_cast<int64_t>(b) * S * 3;

    int count = 0;
    for (int t0 = 0; t0 < clen; t0 += CAND_TILE) {
        const bool need = valid && count < K;
        if (!__syncthreads_or(need)) break;  // every row full: stop loading
        const int n = min(CAND_TILE, clen - t0);
        for (int i = threadIdx.x; i < n; i += QUERY_TILE) {
            const float* ci = c + static_cast<int64_t>(t0 + i) * 3;
            sx[i] = ci[0];
            sy[i] = ci[1];
            sz[i] = ci[2];
        }
        __syncthreads();
        if (need) {
            for (int i = 0; i < n; ++i) {
                const float dx = __fsub_rn(qx, sx[i]);
                const float dy = __fsub_rn(qy, sy[i]);
                const float dz = __fsub_rn(qz, sz[i]);
                const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                           __fmul_rn(dz, dz));
                if (d2 <= r2) {
                    row[count] = t0 + i;
                    if (++count == K) break;
                }
            }
        }
    }
}

}  // namespace

extern "C" int mc_ball_query(const float* query, const float* cand,
                             const int* query_lengths, const int* cand_lengths,
                             int B, int P, int S, int K, float r2, int* out,
                             void* stream) {
    if (B <= 0 || P <= 0) return 0;
    const dim3 grid((P + QUERY_TILE - 1) / QUERY_TILE, B);
    ball_query_kernel<<<grid, QUERY_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        query, cand, query_lengths, cand_lengths, P, S, K, r2, out);
    return static_cast<int>(cudaGetLastError());
}
