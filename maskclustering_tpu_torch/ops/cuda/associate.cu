// Dense projective association of one frame: the claim and the assignment.
//
// Replaces the per-point work of the XLA program
// maskclustering_tpu/models/backprojection.py::associate_frame
// (:229-300 window claim, :319-335 distinct-claim counts, :347-353 the
// assignment against the valid masks). Two entries, one launch each per
// frame:
//
//   mc_associate_claim   one thread per scene point: project the point,
//                        walk the (2w+1)^2 pixel window over depth and id
//                        map, write the claiming ids (N, (2w+1)^2) int16 and
//                        count each distinct (point, mask) pair once in a
//                        shared-memory histogram of k_max + 1 int32 bins,
//                        merged with one global atomic per non-zero bin.
//   mc_associate_assign  one thread per point, after mask_valid is known:
//                        smallest / largest valid claiming id and the
//                        unique id (first == last).
//
// Rounding. The plain versions (models/backprojection.py) round exactly as
// XLA:CPU's fused code does, and so must this: an FMA where XLA contracts a
// multiply into an add, and a single rounding for every other operation.
// Built with -fmad=false, with _rn intrinsics at every float operation:
//   cam   = fma(z, r[i][2], fma(y, r[i][1], x * r[i][0])) + t[i]
//   u     = rint(fma(cam.x / z_safe, fx, cx))            (half to even)
//   q.x   = ((u_c + du) - cx) * d / fx                     (no contraction)
//   dist2 = fma(ez, ez, fma(ex, ex, ey * ey)), e = q - cam
// Integer counts use atomics, so their order does not matter.
//
// Bound: bytes. Per frame the claim reads the cloud (12 B a point) and the
// depth and id maps (8 B a pixel), and writes 2 (2w+1)^2 B a point; the
// assignment reads that plane back and writes 8 B a point. The arithmetic
// (~30 flops a window pixel) is far below the card's FP32 rate at these
// byte counts. The design reads each point once with coalesced loads and
// keeps the window in registers; the id maps are read through the
// read-only cache, where neighbouring points share their pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// params: rotation (row-major 9), translation (3), fx, fy, cx, cy, r2, depth_trunc
struct Params {
  float r[9];
  float t[3];
  float fx, fy, cx, cy, r2, trunc;
};

__device__ __forceinline__ int round_to_int(float x) {
  // jnp.round(x).astype(int32): half to even, NaN -> 0, saturating
  float r = rintf(x);
  if (r != r) r = 0.0f;
  r = fminf(fmaxf(r, -2147483648.0f), 2147483520.0f);
  return static_cast<int>(r);
}

__device__ __forceinline__ int wrap_abs_diff(int a, int b) {
  // |a - b| in wrapping int32 arithmetic, as XLA computes it
  unsigned d = static_cast<unsigned>(a) - static_cast<unsigned>(b);
  unsigned m = (static_cast<int>(d) < 0) ? 0u - d : d;
  return static_cast<int>(m);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
claim_kernel(const float* __restrict__ pts, int n, const float* __restrict__ depth,
             const int* __restrict__ seg, int h, int w, const float* __restrict__ prm,
             int k_max, int16_t* __restrict__ cand, int* __restrict__ n_claimed) {
  constexpr int WW = 2 * W + 1;
  constexpr int K = WW * WW;
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i <= k_max; i += blockDim.x) hist[i] = 0;
  Params p;
#pragma unroll
  for (int i = 0; i < 18; ++i) reinterpret_cast<float*>(&p)[i] = __ldg(prm + i);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    float c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = __fmul_rn(x, p.r[3 * k]);
      acc = __fmaf_rn(y, p.r[3 * k + 1], acc);
      acc = __fmaf_rn(z, p.r[3 * k + 2], acc);
      c[k] = __fadd_rn(acc, p.t[k]);
    }
    const float px = c[0], py = c[1], pz = c[2];
    const bool in_front = pz > 1e-6f;
    const float sz = in_front ? pz : 1.0f;
    const int ui = round_to_int(__fmaf_rn(__fdiv_rn(px, sz), p.fx, p.cx));
    const int vi = round_to_int(__fmaf_rn(__fdiv_rn(py, sz), p.fy, p.cy));
    const int uc = min(max(ui, 0), w - 1);
    const int vc = min(max(vi, 0), h - 1);

    int ids[K];
#pragma unroll
    for (int dv = -W; dv <= W; ++dv) {
#pragma unroll
      for (int du = -W; du <= W; ++du) {
        const int j = (dv + W) * WW + (du + W);
        const int uu = uc + du, vv = vc + dv;
        float d = 0.0f;
        int s = 0;
        if (uu >= 0 && uu < w && vv >= 0 && vv < h) {
          const float dr = __ldg(depth + vv * w + uu);
          d = (dr > 0.0f && dr <= p.trunc) ? dr : 0.0f;
          const int sr = __ldg(seg + vv * w + uu);
          s = (sr < 0 || sr > k_max) ? 0 : sr;
        }
        const bool win_ok = wrap_abs_diff(uu, ui) <= W && wrap_abs_diff(vv, vi) <= W;
        const float qx = __fdiv_rn(__fmul_rn(__fsub_rn(static_cast<float>(uu), p.cx), d), p.fx);
        const float qy = __fdiv_rn(__fmul_rn(__fsub_rn(static_cast<float>(vv), p.cy), d), p.fy);
        const float ex = __fsub_rn(qx, px), ey = __fsub_rn(qy, py), ez = __fsub_rn(d, pz);
        const float dist2 = __fmaf_rn(ez, ez, __fmaf_rn(ex, ex, __fmul_rn(ey, ey)));
        const bool claim = in_front && win_ok && d > 0.0f && s > 0 && dist2 <= p.r2;
        ids[j] = claim ? s : 0;
        cand[static_cast<size_t>(i) * K + j] = static_cast<int16_t>(ids[j]);
      }
    }
    // each (point, mask) pair counts once
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bool first = ids[j] > 0;
#pragma unroll
      for (int q = 0; q < j; ++q) first = first && ids[q] != ids[j];
      if (first) atomicAdd(&hist[ids[j]], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b <= k_max; b += blockDim.x) {
    const int v = hist[b];
    if (v) atomicAdd(n_claimed + b, v);
  }
}

__global__ void __launch_bounds__(kThreads)
assign_kernel(const int16_t* __restrict__ cand, int n, int k, const uint8_t* __restrict__ valid,
              int k_max, int* __restrict__ mop, int16_t* __restrict__ first,
              int16_t* __restrict__ last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int lo = k_max + 1, hi = 0;
  const int16_t* row = cand + static_cast<size_t>(i) * k;
  for (int j = 0; j < k; ++j) {
    const int c = row[j];
    if (c > 0 && __ldg(valid + c)) {
      lo = min(lo, c);
      hi = max(hi, c);
    }
  }
  const bool any = hi > 0;
  lo = any ? lo : 0;
  mop[i] = (any && lo == hi) ? lo : 0;
  first[i] = static_cast<int16_t>(lo);
  last[i] = static_cast<int16_t>(hi);
}

template <int W>
cudaError_t launch_claim(const float* pts, int n, const float* depth, const int* seg, int h,
                         int w, const float* prm, int k_max, int16_t* cand, int* n_claimed,
                         cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(k_max + 1) * sizeof(int);
  claim_kernel<W><<<blocks, kThreads, smem, stream>>>(pts, n, depth, seg, h, w, prm, k_max,
                                                       cand, n_claimed);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mc_associate_claim(const void* pts, int n, const void* depth, const void* seg,
                                  int h, int w, const void* prm, int k_max, int window,
                                  void* cand, void* n_claimed, void* stream) {
  if (n <= 0) return 0;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<const float*>(pts);
  auto* dp = static_cast<const float*>(depth);
  auto* sp = static_cast<const int*>(seg);
  auto* rp = static_cast<const float*>(prm);
  auto* cp = static_cast<int16_t*>(cand);
  auto* np = static_cast<int*>(n_claimed);
  switch (window) {
    case 0: return launch_claim<0>(pp, n, dp, sp, h, w, rp, k_max, cp, np, s);
    case 1: return launch_claim<1>(pp, n, dp, sp, h, w, rp, k_max, cp, np, s);
    case 2: return launch_claim<2>(pp, n, dp, sp, h, w, rp, k_max, cp, np, s);
    case 3: return launch_claim<3>(pp, n, dp, sp, h, w, rp, k_max, cp, np, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mc_associate_assign(const void* cand, int n, int k, const void* valid, int k_max,
                                   void* mop, void* first, void* last, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  assign_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(cand), n, k, static_cast<const uint8_t*>(valid), k_max,
      static_cast<int*>(mop), static_cast<int16_t*>(first), static_cast<int16_t*>(last));
  return static_cast<int>(cudaGetLastError());
}
