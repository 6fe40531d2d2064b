// Z-buffered point splatting of one frame: the depth pass and the colour pass.
//
// Replaces the XLA program maskclustering_tpu/visualize/top_images.py::
// project_zbuffer (:24-62): project a cloud into a pinhole camera, keep the
// nearest depth of each pixel (a scatter-min), then the largest packed colour
// among the points at that depth (a scatter-max). Two entries, one thread a
// point each:
//
//   mc_splat_depth   project; a valid point takes atomicMin on its pixel of the
//       (H*W + 1) int32 depth buffer, which the caller fills with the bits of
//       +inf (0x7f800000). Every valid depth is > 1e-6, and positive float32
//       values order as their int32 bit patterns do, so an integer min is the
//       float min.
//   mc_splat_color   project again; visible = valid && z <= zbuf[lin]; a
//       visible point takes atomicMax of its packed colour (r << 16 | g << 8
//       | b) on its pixel of the zeroed (H*W + 1) int32 code buffer. Writes
//       visible (N) as bytes.
//
// Points that are not valid touch no pixel: in the XLA program they go to the
// dump slot H*W with +inf and 0, which leaves that slot as it was filled. Min
// and max do not depend on the order of the atomics, so the buffers are
// bit-equal to the plain version's (visualize/top_images.py) and to
// themselves from run to run.
//
// Rounding. As jitted XLA:CPU computes the program, with -fmad=false and an
// _rn intrinsic at each float operation:
//   cam   = fma(z, r[i][2], fma(y, r[i][1], x * r[i][0])) + t[i]
//   px    = rint((fx * cam.x) / safe_z + cx)            (half to even)
//   rgb8  = clamp(trunc(c * 255), 0, 255)                (toward zero)
// Float-to-int conversions saturate and take NaN to 0, as XLA's do.
//
// Bound: bytes. The depth pass reads 12 B a point and, at most, reads and
// writes 4 B a pixel it hits; the colour pass reads 24 B a point, reads the
// depth of its pixel and writes 1 B a point and 4 B a hit pixel. A few dozen
// FP32 operations a point (two IEEE divisions among them) are far below the
// card's rate; at the sizes of one object in one frame the launch sets the
// time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// params: rotation (row-major 9), translation (3), fx, fy, cx, cy
struct Params {
  float r[9];
  float t[3];
  float fx, fy, cx, cy;
};

__device__ __forceinline__ int round_to_int(float x) {
  // jnp.round(x).astype(int32): half to even, NaN -> 0, saturating
  float r = rintf(x);
  if (r != r) r = 0.0f;
  r = fminf(fmaxf(r, -2147483648.0f), 2147483520.0f);
  return static_cast<int>(r);
}

__device__ __forceinline__ int channel(float c) {
  // clip((c * 255.0).astype(int32), 0, 255): truncation toward zero, with the
  // conversion saturating and NaN -> 0 (cvt.rzi does both)
  const int v = __float2int_rz(__fmul_rn(c, 255.0f));
  return min(max(v, 0), 255);
}

struct Hit {
  bool valid;
  int lin;
  float z;
};

__device__ __forceinline__ Hit project(const float* __restrict__ pts, int i, const Params& p,
                                      int h, int w) {
  const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
  float cam[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float acc = __fmaf_rn(z, p.r[3 * k + 2],
                                __fmaf_rn(y, p.r[3 * k + 1], __fmul_rn(x, p.r[3 * k])));
    cam[k] = __fadd_rn(acc, p.t[k]);
  }
  Hit hit;
  hit.z = cam[2];
  const bool in_front = cam[2] > 1e-6f;
  const float safe_z = in_front ? cam[2] : 1.0f;
  const int px = round_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(p.fx, cam[0]), safe_z), p.cx));
  const int py = round_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(p.fy, cam[1]), safe_z), p.cy));
  hit.valid = in_front && px >= 0 && px < w && py >= 0 && py < h;
  hit.lin = hit.valid ? py * w + px : h * w;
  return hit;
}

__device__ __forceinline__ Params load_params(const float* __restrict__ prm) {
  Params p;
#pragma unroll
  for (int k = 0; k < 9; ++k) p.r[k] = prm[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) p.t[k] = prm[9 + k];
  p.fx = prm[12];
  p.fy = prm[13];
  p.cx = prm[14];
  p.cy = prm[15];
  return p;
}

__global__ void __launch_bounds__(kThreads)
    splat_depth_kernel(const float* __restrict__ pts, int n, const float* __restrict__ prm,
                       int h, int w, int* __restrict__ zbuf) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Params p = load_params(prm);
  const Hit hit = project(pts, i, p, h, w);
  if (hit.valid) atomicMin(zbuf + hit.lin, __float_as_int(hit.z));
}

__global__ void __launch_bounds__(kThreads)
    splat_color_kernel(const float* __restrict__ pts, const float* __restrict__ colors, int n,
                       const float* __restrict__ prm, int h, int w,
                       const int* __restrict__ zbuf, int* __restrict__ codebuf,
                       uint8_t* __restrict__ visible) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Params p = load_params(prm);
  const Hit hit = project(pts, i, p, h, w);
  const bool vis = hit.valid && hit.z <= __int_as_float(zbuf[hit.lin]);
  visible[i] = vis ? 1 : 0;
  if (!vis) return;
  const int code = (channel(colors[3 * i]) << 16) | (channel(colors[3 * i + 1]) << 8) |
                   channel(colors[3 * i + 2]);
  atomicMax(codebuf + hit.lin, code);
}

// this library links its own CUDA runtime, whose current device is set per
// host thread, so the entry sets it before each launch.
int set_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

}  // namespace

extern "C" int mc_splat_depth(const void* pts, int n, const void* prm, int h, int w, void* zbuf,
                              int device, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = set_device(device)) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  splat_depth_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n, static_cast<const float*>(prm), h, w,
      static_cast<int*>(zbuf));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mc_splat_color(const void* pts, const void* colors, int n, const void* prm, int h,
                              int w, const void* zbuf, void* codebuf, void* visible, int device,
                              void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = set_device(device)) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  splat_color_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(colors), n,
      static_cast<const float*>(prm), h, w, static_cast<const int*>(zbuf),
      static_cast<int*>(codebuf), static_cast<uint8_t*>(visible));
  return static_cast<int>(cudaGetLastError());
}
