// Analytic depth and id rendering of a scene of axis-aligned boxes on the
// floor plane z = 0, for F posed pinhole cameras in one launch.
//
// Replaces the XLA program maskclustering_tpu/utils/synthetic.py::
// render_depth_seg_device (:231-308): for each pixel, the ray through it hits
// the nearest box by the slab test (:272-293) or the floor (:294-301); the
// pixel's depth is the ray parameter t (the camera z, since the ray direction
// has z = 1 in camera space), 0 where nothing is hit, and its id is the
// frame's mask id of the box hit (perms[f][k] for box k), 0 for the floor or
// nothing. The XLA program scans the boxes in chunks of 8: within a chunk an
// argmin (the first index on ties), across chunks a strict "closer" test, so
// the first box in index order at the least t wins. One thread a pixel tests
// the boxes in index order with a strict < and gives the same box.
//
// One block covers 256 pixels of one frame (blockIdx.y). It stages the
// frame's box corners minus the camera centre in shared memory, per axis in
// ascending order: the XLA program subtracts per pixel, but the difference is
// the same float for every pixel of a frame, and the slab test takes the
// minimum and maximum of the two planes anyway. Padded boxes of the XLA
// program never hit (its `real` mask), so only the K real boxes are passed.
//
// Rounding. As jitted XLA:CPU computes the program, with -fmad=false and an
// _rn intrinsic at each float operation (found by comparing candidate forms
// with the jitted program on random poses):
//   dx    = (u - cx) / fx,  dy = (v - cy) / fy           (u, v int32 -> f32)
//   d[i]  = fma(dy, R[i][1], dx * R[i][0]) + R[i][2]     (d_cam @ R.T)
//   sd    = |d| < 1e-12 ? 1e-12 : d                      (safe_d)
//   t1, t2 = (bmin - eye) / sd, (bmax - eye) / sd       (IEEE divisions)
//   tmin  = max over axes of min(t1, t2), tmax = min over axes of max(t1, t2)
//   t     = ok && (tmin > 0 ? tmin : tmax) > 0 ? that : +inf,
//           ok = tmax >= tmin && tmax > 0
//   floor = -eye.z / (|d.z| < 1e-12 ? 1e-12 : d.z), taken when in (0, best)
// min and max propagate NaN, as XLA's do.
//
// Bound: operations. Each (pixel, box) pair costs six divisions, and 480x640
// frames of 36 boxes do some 1.8e10 operations a 250-frame scene against
// 614 MB of output (8 B a pixel). On the card an IEEE division is a
// reciprocal estimate, Newton steps, a residual, a correction and a range
// check with a slow branch, some ten instructions; a loop of IEEE divisions
// pays that six times a pair, and NaN-propagating minima and maxima on top.
//
// The design, three exact steps.
// (1) The divisor of all six quotients of a pair is one of the pixel's three
//     sd[a], the same for every box: the reciprocal is taken once a pixel and
//     axis, and a quotient costs four instructions (the argument below).
// (2) NaN can only enter through the pixel's directions or the frame's
//     corners: they are tested once a pixel and once a frame, against the
//     argument's range too, and the box loop uses plain minima and maxima and
//     skips a box's near planes when its far planes give tmax <= 0.
// (3) A warp of 32 pixels of one row bounds each box from its two end rays
//     and skips the boxes that no lane's slab test can pass (slab_warp).
// A pixel or frame outside the range takes the exact path: the loop of IEEE
// divisions and NaN-propagating minima and maxima, box by box.
//
// The quotient q = RN(a / b), for b = sd[a] and a = a corner minus the eye
// (RN: float32 round to nearest even; every step below one _rn operation).
// Per pixel and axis:
//   yh = RN(1 / b)                     (__frcp_rn, correctly rounded)
//   e  = fma(-b, yh, 1)                (exact: |e| < 2^-24, a multiple of
//                                       ulp(b) ulp(yh))
//   yl = RN(e * yh)                    (so yh + yl = 1/b (1 + O(2^-47)))
// Per pair:
//   q0 = fma(a, yh, RN(a * yl))
//   q  = fma(fma(-b, q0, a), yh, q0)
// Why q = RN(a / b). Scale a and b by powers of two into [1, 2) (every step
// commutes with that while nothing under- or overflows) and take them
// positive (every step is odd in a and in b). Then z = a / b is in (1/2, 2),
// |yh - 1/b| <= 2^-25, and a yh + RN(a yl) differs from z by less than
// 3 * 2^-47, far below ulp(z) >= 2^-24, so q0 = RN of it is a faithful
// rounding of z (one of the two floats around it). Markstein's theorem
// (P. Markstein, IBM J. Res. Dev. 34(1), 1990; Muller et al., Handbook of
// Floating-Point Arithmetic, the FMA division chapter): if y is within half
// an ulp of 1/b and q0 is faithful, the residual r = a - b q0 is exact in one
// FMA and RN(q0 + r y) = RN(a / b). yh = RN(1/b) is within half an ulp.
// Range: |b| in [2^-40, 2^40] (safe_d keeps |b| >= 1e-12 > 2^-40) and
// |a| in [2^-32, 2^32] or a = 0. Then z, yh, yl (when not 0), a yl, r and
// r yh are all normal floats below 2^73: nothing under- or overflows. a = 0
// gives q = 0, possibly of the other sign than a / b: the slab test only
// compares t with 0, with other t and with the best, and writes a t only
// when it is > 0, so the sign of a zero never reaches an output.
// tests/test_torch_synthetic_device.py emulates these steps on the CPU
// against IEEE division, and chip_smoke.py holds mc_render_quotients against
// torch's division on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// boxes a launch takes: 8 floats each in shared memory, 64 KB at most
constexpr int kMaxBoxes = 2048;
// the quotient's range (see above)
constexpr float kMaxDivisor = 0x1p40f;
constexpr float kMinNumerator = 0x1p-32f;
constexpr float kMaxNumerator = 0x1p32f;
constexpr unsigned kWarp = 0xffffffffu;

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

__device__ __forceinline__ float safe(float d) { return fabsf(d) < 1e-12f ? 1e-12f : d; }

// the reciprocal of b to about 2^-47 (yh + yl), and -b
struct Divisor {
  float nb, yh, yl;
};

__device__ __forceinline__ Divisor divisor(float b) {
  const float yh = __frcp_rn(b);
  const float e = __fmaf_rn(-b, yh, 1.0f);
  return {-b, yh, __fmul_rn(e, yh)};
}

// RN(a / b) for a and b in the range above
__device__ __forceinline__ float quotient(float a, const Divisor& d) {
  const float q0 = __fmaf_rn(a, d.yh, __fmul_rn(a, d.yl));
  return __fmaf_rn(__fmaf_rn(d.nb, q0, a), d.yh, q0);
}

__device__ __forceinline__ bool numerator_in_range(float a) {
  const float m = fabsf(a);
  return m == 0.0f || (m >= kMinNumerator && m <= kMaxNumerator);
}

// The exact path: every quotient an IEEE division, minima and maxima that
// propagate NaN. rel (K, 8): per box the two corners minus the eye, a pair
// per axis ascending when both are numbers, always the two values the XLA
// program divides.
__device__ __forceinline__ void slab_exact(const float* rel, int k_total, const float* sd,
                                           float& best, int& hit) {
  for (int b = 0; b < k_total; ++b) {
    const float* r = rel + 8 * b;
    float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t1 = __fdiv_rn(r[a], sd[a]);
      const float t2 = __fdiv_rn(r[4 + a], sd[a]);
      const float lo = nan_min(t1, t2), hi = nan_max(t1, t2);
      tmin = a == 0 ? lo : nan_max(tmin, lo);
      tmax = a == 0 ? hi : nan_min(tmax, hi);
    }
    const bool ok = tmax >= tmin && tmax > 0.0f;
    const float t = tmin > 0.0f ? tmin : tmax;
    if (ok && t > 0.0f && t < best) {
      best = t;
      hit = b + 1;
    }
  }
}

// The fast path's test of box b: no NaN anywhere, so plain minima and
// maxima. With an axis's corners ascending (lo <= hi), RN's monotony makes
// lo / sd the near plane and hi / sd the far one when sd > 0, the other way
// round when sd < 0. A box whose far planes give tmax <= 0 fails `ok`
// whatever tmin is, so its near planes are skipped. With tmax > 0 the test
// reduces to tmax >= tmin and t < best (t is tmin when tmin > 0, else tmax:
// > 0 either way).
__device__ __forceinline__ void fast_box(const float* rel, int b, const Divisor* dv,
                                         const bool* pos, float& best, int& hit) {
  const float4 lo = *reinterpret_cast<const float4*>(rel + 8 * b);
  const float4 hi = *reinterpret_cast<const float4*>(rel + 8 * b + 4);
  const float tmax = fminf(fminf(quotient(pos[0] ? hi.x : lo.x, dv[0]),
                                 quotient(pos[1] ? hi.y : lo.y, dv[1])),
                           quotient(pos[2] ? hi.z : lo.z, dv[2]));
  if (!(tmax > 0.0f)) return;
  const float tmin = fmaxf(fmaxf(quotient(pos[0] ? lo.x : hi.x, dv[0]),
                                 quotient(pos[1] ? lo.y : hi.y, dv[1])),
                           quotient(pos[2] ? lo.z : hi.z, dv[2]));
  if (tmax >= tmin) {
    const float t = tmin > 0.0f ? tmin : tmax;
    if (t < best) {
      best = t;
      hit = b + 1;
    }
  }
}

// The warp's cull. Along one image row each step of d[i](u) is a monotone
// RN operation of u (u - cx, / fx, * R[i][0], the FMA's addend, + R[i][2]),
// so d[i] is monotone over the warp's 32 pixels; when both ends' d[i] are
// >= 1e-12 (or both <= -1e-12) so is every pixel's, safe() leaves it, and
// its sign is the warp's. RN(n / sd) is monotone in sd of one sign, so each
// lane's near and far plane of a box lies between their values at the two
// end rays. When the least upper bound of the far planes is <= 0 or below
// the greatest lower bound of the near planes, every lane has tmax <= 0 or
// tmax < tmin, fails `ok`, and would leave best and hit as they are: the box
// is skipped. Each lane bounds one box of a group of 32; then every lane
// tests the group's remaining boxes in index order.
__device__ __forceinline__ void slab_warp(const float* rel, int k_total, const float* sd,
                                          const float* end0, const float* end1, float& best,
                                          int& hit) {
  const Divisor dv[3] = {divisor(sd[0]), divisor(sd[1]), divisor(sd[2])};
  const bool pos[3] = {sd[0] > 0.0f, sd[1] > 0.0f, sd[2] > 0.0f};
  // the end lanes' own divisors (their sd is their d: clear of zero)
  Divisor d0[3], d1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    d0[a] = {__shfl_sync(kWarp, dv[a].nb, 0), __shfl_sync(kWarp, dv[a].yh, 0),
             __shfl_sync(kWarp, dv[a].yl, 0)};
    d1[a] = {__shfl_sync(kWarp, dv[a].nb, 31), __shfl_sync(kWarp, dv[a].yh, 31),
             __shfl_sync(kWarp, dv[a].yl, 31)};
  }
  for (int base = 0; base < k_total; base += 32) {
    const int b = base + static_cast<int>(threadIdx.x & 31);
    bool keep = false;
    if (b < k_total) {
      const float4 lo = *reinterpret_cast<const float4*>(rel + 8 * b);
      const float4 hi = *reinterpret_cast<const float4*>(rel + 8 * b + 4);
      const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
      float far_hi = 0.0f, near_lo = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float fr = pos[a] ? h[a] : l[a], nr = pos[a] ? l[a] : h[a];
        const float f = fmaxf(quotient(fr, d0[a]), quotient(fr, d1[a]));
        const float n = fminf(quotient(nr, d0[a]), quotient(nr, d1[a]));
        far_hi = a == 0 ? f : fminf(far_hi, f);
        near_lo = a == 0 ? n : fmaxf(near_lo, n);
      }
      keep = far_hi > 0.0f && far_hi >= near_lo;
    }
    for (unsigned m = __ballot_sync(kWarp, keep); m != 0; m &= m - 1) {
      fast_box(rel, base + __ffs(m) - 1, dv, pos, best, hit);
    }
  }
}

__device__ __forceinline__ bool clear_of_zero(float a, float b) {
  return (a >= 1e-12f && b >= 1e-12f) || (a <= -1e-12f && b <= -1e-12f);
}

// boxes (K, 2, 3): min corner, max corner; poses (F, 4, 4) camera-to-world;
// intr (F, 3, 3); perms (F, K) int32; depth (F, H, W) f32, seg (F, H, W)
// int32. kExactOnly: every pixel on the exact path (the kernel before the
// division form and the cull, kept for timing the two against each other).
template <bool kExactOnly>
__global__ void __launch_bounds__(kThreads)
    render_kernel(const float* __restrict__ boxes, int k_total, const float* __restrict__ poses,
                  const float* __restrict__ intr, const int* __restrict__ perms, int h, int w,
                  float* __restrict__ depth, int* __restrict__ seg) {
  extern __shared__ float4 rel4[];  // (K, 8): lo corner minus eye, pad, hi, pad
  float* rel = reinterpret_cast<float*>(rel4);
  const int f = blockIdx.y;
  const float* c2w = poses + 16 * static_cast<size_t>(f);
  const float ex = c2w[3], ey = c2w[7], ez = c2w[11];
  bool in_range = true;
  for (int i = threadIdx.x; i < 3 * k_total; i += kThreads) {
    const int b = i / 3, a = i % 3;
    const float e = a == 0 ? ex : (a == 1 ? ey : ez);
    const float r0 = __fsub_rn(boxes[6 * b + a], e), r1 = __fsub_rn(boxes[6 * b + 3 + a], e);
    // ascending when both are numbers; a permutation of the two always
    const bool keep = r0 < r1;
    rel[8 * b + a] = keep ? r0 : r1;
    rel[8 * b + 4 + a] = keep ? r1 : r0;
    in_range = in_range && numerator_in_range(r0) && numerator_in_range(r1);
  }
  const bool frame_fast = __syncthreads_and(in_range) && !kExactOnly;

  const long long hw = static_cast<long long>(h) * w;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // a lane past the frame's end computes the last pixel's ray and writes
  // nothing: every lane of a warp reaches the warp-wide steps
  const bool valid = p < hw;
  const long long q = valid ? p : hw - 1;
  const int v = static_cast<int>(q / w), u = static_cast<int>(q % w);
  const float* k = intr + 9 * static_cast<size_t>(f);
  const float dx = __fdiv_rn(__fsub_rn(static_cast<float>(u), k[2]), k[0]);
  const float dy = __fdiv_rn(__fsub_rn(static_cast<float>(v), k[5]), k[4]);
  float d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d[i] = __fadd_rn(__fmaf_rn(dy, c2w[4 * i + 1], __fmul_rn(dx, c2w[4 * i])), c2w[4 * i + 2]);
  }
  const float sd[3] = {safe(d[0]), safe(d[1]), safe(d[2])};

  float best = __int_as_float(0x7f800000);
  int hit = 0;
  // NaN and inf fail the range test; |sd| >= 1e-12 > 2^-40 by safe()
  const bool fast = frame_fast && fabsf(sd[0]) <= kMaxDivisor && fabsf(sd[1]) <= kMaxDivisor &&
                    fabsf(sd[2]) <= kMaxDivisor;
  // the warp's end rays, lanes 0 and 31 (a block's warps start at multiples
  // of 32 pixels), on one row when their columns are 31 apart
  float end0[3], end1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    end0[i] = __shfl_sync(kWarp, d[i], 0);
    end1[i] = __shfl_sync(kWarp, d[i], 31);
  }
  const bool one_row = __shfl_sync(kWarp, u, 31) == __shfl_sync(kWarp, u, 0) + 31;
  if (__all_sync(kWarp, valid && fast) && one_row && clear_of_zero(end0[0], end1[0]) &&
      clear_of_zero(end0[1], end1[1]) && clear_of_zero(end0[2], end1[2])) {
    slab_warp(rel, k_total, sd, end0, end1, best, hit);
  } else if (fast) {
    const Divisor dv[3] = {divisor(sd[0]), divisor(sd[1]), divisor(sd[2])};
    const bool pos[3] = {sd[0] > 0.0f, sd[1] > 0.0f, sd[2] > 0.0f};
    for (int b = 0; b < k_total; ++b) fast_box(rel, b, dv, pos, best, hit);
  } else {
    slab_exact(rel, k_total, sd, best, hit);
  }
  if (!valid) return;
  const float t_floor = __fdiv_rn(-ez, sd[2]);
  if (t_floor > 0.0f && t_floor < best) {
    best = t_floor;
    hit = 0;
  }
  const size_t o = static_cast<size_t>(f) * static_cast<size_t>(hw) + static_cast<size_t>(p);
  depth[o] = isfinite(best) ? best : 0.0f;
  seg[o] = hit == 0 ? 0 : perms[static_cast<size_t>(f) * k_total + (hit - 1)];
}

// the quotient applied to n pairs: out[i] = RN(num[i] / sd[i]) for pairs in
// its range (chip_smoke.py holds it against torch's division)
__global__ void quotient_kernel(const float* __restrict__ num, const float* __restrict__ sd,
                                float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = quotient(num[i], divisor(sd[i]));
}

template <bool kExactOnly>
int launch_render(const void* boxes, int k_total, const void* poses, const void* intr,
                  const void* perms, int f, int h, int w, void* depth, void* seg, int device,
                  void* stream) {
  if (k_total < 0 || k_total > kMaxBoxes || f < 0 || f > 65535 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f == 0) return 0;
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  const long long hw = static_cast<long long>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads), static_cast<unsigned>(f));
  const size_t smem = sizeof(float) * 8 * static_cast<size_t>(k_total);
  if (smem > 48 * 1024) {
    if (const cudaError_t err = cudaFuncSetAttribute(render_kernel<kExactOnly>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     static_cast<int>(smem))) {
      return static_cast<int>(err);
    }
  }
  render_kernel<kExactOnly><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), k_total, static_cast<const float*>(poses),
      static_cast<const float*>(intr), static_cast<const int*>(perms), h, w,
      static_cast<float*>(depth), static_cast<int*>(seg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// this library links its own CUDA runtime, whose current device is set per
// host thread, so each entry sets it before its launch.
extern "C" int mc_render_depth_seg(const void* boxes, int k_total, const void* poses,
                                   const void* intr, const void* perms, int f, int h, int w,
                                   void* depth, void* seg, int device, void* stream) {
  return launch_render<false>(boxes, k_total, poses, intr, perms, f, h, w, depth, seg, device,
                              stream);
}

// every pixel on the exact path, for chip_smoke.py's timing
extern "C" int mc_render_depth_seg_exact(const void* boxes, int k_total, const void* poses,
                                         const void* intr, const void* perms, int f, int h,
                                         int w, void* depth, void* seg, int device,
                                         void* stream) {
  return launch_render<true>(boxes, k_total, poses, intr, perms, f, h, w, depth, seg, device,
                             stream);
}

// the division form on n pairs, a test entry (on no path of the program)
extern "C" int mc_render_quotients(const void* num, const void* sd, void* out, long long n,
                                   int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quotient_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(num), static_cast<const float*>(sd), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
