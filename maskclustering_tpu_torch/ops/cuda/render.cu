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
// the first box in index order at the least t wins. One thread a pixel loops
// over all boxes in index order with a strict < and gives the same box.
//
// One block covers 256 pixels of one frame (blockIdx.y). It stages the
// frame's box corners minus the camera centre (6 floats a box) in shared
// memory: the XLA program subtracts per pixel, but the difference is the same
// float for every pixel of a frame. Padded boxes of the XLA program never hit
// (its `real` mask), so only the K real boxes are passed.
//
// Rounding. As jitted XLA:CPU computes the program, with -fmad=false and an
// _rn intrinsic at each float operation (found by comparing candidate forms
// with the jitted program on random poses):
//   dx    = (u - cx) / fx,  dy = (v - cy) / fy           (u, v int32 -> f32)
//   d[i]  = fma(dy, R[i][1], dx * R[i][0]) + R[i][2]     (d_cam @ R.T)
//   sd    = |d| < 1e-12 ? 1e-12 : d                      (safe_d)
//   t1, t2 = (bmin - eye) / sd, (bmax - eye) / sd
//   tmin  = max over axes of min(t1, t2), tmax = min over axes of max(t1, t2)
//   t     = ok && (tmin > 0 ? tmin : tmax) > 0 ? that : +inf,
//           ok = tmax >= tmin && tmax > 0
//   floor = -eye.z / (|d.z| < 1e-12 ? 1e-12 : d.z), taken when in (0, best)
// min and max propagate NaN, as XLA's do.
//
// Bound: operations. Each (pixel, box) pair costs six IEEE divisions, and
// 480x640 frames of 36 boxes do some 1.7e10 operations a 250-frame scene
// against 614 MB of output (8 B a pixel): the divisions, each several
// instructions on the card, set the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// boxes a launch takes: 6 floats each in shared memory, 48 KB at most
constexpr int kMaxBoxes = 2048;

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

__device__ __forceinline__ float safe(float d) { return fabsf(d) < 1e-12f ? 1e-12f : d; }

// boxes (K, 2, 3): min corner, max corner; poses (F, 4, 4) camera-to-world;
// intr (F, 3, 3); perms (F, K) int32; depth (F, H, W) f32, seg (F, H, W) int32
__global__ void __launch_bounds__(kThreads)
    render_kernel(const float* __restrict__ boxes, int k_total, const float* __restrict__ poses,
                  const float* __restrict__ intr, const int* __restrict__ perms, int h, int w,
                  float* __restrict__ depth, int* __restrict__ seg) {
  extern __shared__ float rel[];  // (K, 6): bmin - eye, bmax - eye
  const int f = blockIdx.y;
  const float* c2w = poses + 16 * static_cast<size_t>(f);
  const float ex = c2w[3], ey = c2w[7], ez = c2w[11];
  for (int i = threadIdx.x; i < 6 * k_total; i += kThreads) {
    const int a = i % 3;
    rel[i] = __fsub_rn(boxes[i], a == 0 ? ex : (a == 1 ? ey : ez));
  }
  __syncthreads();

  const long long hw = static_cast<long long>(h) * w;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int v = static_cast<int>(p / w), u = static_cast<int>(p % w);
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
  for (int b = 0; b < k_total; ++b) {
    const float* r = rel + 6 * b;
    float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t1 = __fdiv_rn(r[a], sd[a]);
      const float t2 = __fdiv_rn(r[3 + a], sd[a]);
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
  const float t_floor = __fdiv_rn(-ez, sd[2]);
  if (t_floor > 0.0f && t_floor < best) {
    best = t_floor;
    hit = 0;
  }
  const size_t o = static_cast<size_t>(f) * static_cast<size_t>(hw) + static_cast<size_t>(p);
  depth[o] = isfinite(best) ? best : 0.0f;
  seg[o] = hit == 0 ? 0 : perms[static_cast<size_t>(f) * k_total + (hit - 1)];
}

}  // namespace

// this library links its own CUDA runtime, whose current device is set per
// host thread, so the entry sets it before each launch.
extern "C" int mc_render_depth_seg(const void* boxes, int k_total, const void* poses,
                                   const void* intr, const void* perms, int f, int h, int w,
                                   void* depth, void* seg, int device, void* stream) {
  if (k_total < 0 || k_total > kMaxBoxes || f < 0 || f > 65535 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f == 0) return 0;
  if (const cudaError_t err = cudaSetDevice(device)) return static_cast<int>(err);
  const long long hw = static_cast<long long>(h) * w;
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads), static_cast<unsigned>(f));
  const size_t smem = sizeof(float) * 6 * static_cast<size_t>(k_total);
  render_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), k_total, static_cast<const float*>(poses),
      static_cast<const float*>(intr), static_cast<const int*>(perms), h, w,
      static_cast<float*>(depth), static_cast<int*>(seg));
  return static_cast<int>(cudaGetLastError());
}
