// Z-buffered point splatting of an object into F frames: the depth pass, the
// colour pass and the box of the filled pixels.
//
// Replaces the XLA program maskclustering_tpu/visualize/top_images.py::
// project_zbuffer (:24-62): project a cloud into a pinhole camera, keep the
// nearest depth of each pixel (a scatter-min), then the largest packed colour
// among the points at that depth (a scatter-max); and bbox_by_projection
// (:66-81), the box of the pixels whose depth is finite. Each entry takes the
// F cameras of one object and makes one pass over its points: a block stages
// the cameras in shared memory, and each thread keeps its point in registers
// and loops over the frames, so the points are read from device memory once
// whatever F is. Three entries:
//
//   mc_splat_depth   fills the (F, H*W + 1) int32 depth buffers with the bits
//       of +inf (0x7f800000), then projects; a valid point takes atomicMin on
//       its pixel of its frame's buffer. Every valid depth is > 1e-6, and
//       positive float32 values order as their int32 bit patterns do, so an
//       integer min is the float min.
//   mc_splat_color   zeroes the (F, H*W + 1) int32 code buffers, then projects
//       again; visible = valid && z <= zbuf[lin]; a visible point takes
//       atomicMax of its packed colour (r << 16 | g << 8 | b) on its pixel.
//       Writes visible (F, N) as bytes.
//   mc_splat_bbox    the (F, 4) int32 box (min px, min py, max px, max py) of
//       the points that are valid and whose camera depth is below +inf: the
//       pixels such points land on are exactly those whose depth in the
//       buffer above is finite (a point at z = +inf lands but leaves +inf
//       there). Within a warp a redux.sync min and max, across the block's
//       warps shared memory, then one atomicMin / atomicMax a block, frame and
//       coordinate on the output, which starts at (INT_MAX, INT_MAX, INT_MIN,
//       INT_MIN): a frame no point fills keeps those values.
//
// Points that are not valid touch no pixel: in the XLA program they go to the
// dump slot H*W with +inf and 0, which leaves that slot as it was filled. Min
// and max do not depend on the order of the atomics, so the buffers and boxes
// are bit-equal to the plain versions' (visualize/top_images.py) and to
// themselves from run to run.
//
// Rounding. As jitted XLA:CPU computes the program, with -fmad=false and an
// _rn intrinsic at each float operation:
//   cam   = fma(z, r[i][2], fma(y, r[i][1], x * r[i][0])) + t[i]
//   px    = rint((fx * cam.x) / safe_z + cx)            (half to even)
//   rgb8  = clamp(trunc(c * 255), 0, 255)                (toward zero)
// Float-to-int conversions saturate and take NaN to 0, as XLA's do.
//
// Bound: bytes. The depth pass reads 12 B a point and 64 B a camera and
// writes each 4 B pixel of its buffers; the colour pass reads 24 B a point,
// the cameras and the depth of each pixel a point lands on (at most 4 B a
// (frame, point), at most the buffers), and writes the code buffers and 1 B
// a (frame, point); the box reads 12 B a point and the cameras and writes 16 B
// a frame. A few dozen FP32 operations a (frame, point), two IEEE divisions
// among them, are far below the card's rate. One block covers 256 points: the
// largest object of the full-size scan (47,646 points) is 187 blocks, more
// than the card's 132 SMs, and all are resident at once. At these sizes the
// launches set the time, so each entry is one library call that fills its own
// buffers on the caller's stream before its pass.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// cameras staged in shared memory at a time (16 floats each, 4 KB)
constexpr int kCams = 64;
constexpr int kParams = 16;
constexpr int kInfBits = 0x7f800000;

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
  int px, py;
  int lin;
  float z;
};

__device__ __forceinline__ Hit project(float x, float y, float z, const Params& p, int h,
                                      int w) {
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
  hit.px = round_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(p.fx, cam[0]), safe_z), p.cx));
  hit.py = round_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(p.fy, cam[1]), safe_z), p.cy));
  hit.valid = in_front && hit.px >= 0 && hit.px < w && hit.py >= 0 && hit.py < h;
  hit.lin = hit.valid ? hit.py * w + hit.px : h * w;
  return hit;
}

__device__ __forceinline__ Params load_params(const float* prm) {
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

// Stage cameras [f0, f0 + fc) into shared memory. Every thread of the block
// calls it, the inactive ones too (it holds two barriers).
__device__ __forceinline__ void stage_cameras(float* cams, const float* __restrict__ prm, int f0,
                                              int fc) {
  __syncthreads();  // the previous chunk is no longer read
  for (int k = threadIdx.x; k < fc * kParams; k += kThreads) cams[k] = prm[f0 * kParams + k];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fill_kernel(int* __restrict__ buf, long long count,
                                                        int value) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // whole int4 stores over the 16-byte aligned body, ints over the tail
  const long long quads = count / 4;
  int4* __restrict__ buf4 = reinterpret_cast<int4*>(buf);
  const int4 v4 = make_int4(value, value, value, value);
  for (long long q = i; q < quads; q += stride) buf4[q] = v4;
  for (long long k = 4 * quads + i; k < count; k += stride) buf[k] = value;
}

__global__ void __launch_bounds__(kThreads)
    splat_depth_kernel(const float* __restrict__ pts, int n, const float* __restrict__ prm, int f,
                       int h, int w, int* __restrict__ zbuf) {
  __shared__ float cams[kCams * kParams];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const float x = active ? pts[3 * i] : 0.0f;
  const float y = active ? pts[3 * i + 1] : 0.0f;
  const float z = active ? pts[3 * i + 2] : 0.0f;
  const long long frame = static_cast<long long>(h) * w + 1;
  for (int f0 = 0; f0 < f; f0 += kCams) {
    const int fc = min(kCams, f - f0);
    stage_cameras(cams, prm, f0, fc);
    if (!active) continue;
    for (int j = 0; j < fc; ++j) {
      const Hit hit = project(x, y, z, load_params(cams + kParams * j), h, w);
      if (hit.valid) atomicMin(zbuf + (f0 + j) * frame + hit.lin, __float_as_int(hit.z));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    splat_color_kernel(const float* __restrict__ pts, const float* __restrict__ colors, int n,
                       const float* __restrict__ prm, int f, int h, int w,
                       const int* __restrict__ zbuf, int* __restrict__ codebuf,
                       uint8_t* __restrict__ visible) {
  __shared__ float cams[kCams * kParams];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const float x = active ? pts[3 * i] : 0.0f;
  const float y = active ? pts[3 * i + 1] : 0.0f;
  const float z = active ? pts[3 * i + 2] : 0.0f;
  const int code = active ? (channel(colors[3 * i]) << 16) | (channel(colors[3 * i + 1]) << 8) |
                                channel(colors[3 * i + 2])
                          : 0;
  const long long frame = static_cast<long long>(h) * w + 1;
  for (int f0 = 0; f0 < f; f0 += kCams) {
    const int fc = min(kCams, f - f0);
    stage_cameras(cams, prm, f0, fc);
    if (!active) continue;
    for (int j = 0; j < fc; ++j) {
      const Hit hit = project(x, y, z, load_params(cams + kParams * j), h, w);
      const long long base = (f0 + j) * frame;
      const bool vis = hit.valid && hit.z <= __int_as_float(zbuf[base + hit.lin]);
      visible[static_cast<long long>(f0 + j) * n + i] = vis ? 1 : 0;
      if (vis) atomicMax(codebuf + base + hit.lin, code);
    }
  }
}

__global__ void box_init_kernel(int* __restrict__ box, int f) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k < 4 * f) box[k] = (k % 4) < 2 ? INT_MAX : INT_MIN;
}

__global__ void __launch_bounds__(kThreads)
    splat_bbox_kernel(const float* __restrict__ pts, int n, const float* __restrict__ prm, int f,
                      int h, int w, int* __restrict__ box) {
  __shared__ float cams[kCams * kParams];
  __shared__ int part[kWarps][4];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const float x = active ? pts[3 * i] : 0.0f;
  const float y = active ? pts[3 * i + 1] : 0.0f;
  const float z = active ? pts[3 * i + 2] : 0.0f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int f0 = 0; f0 < f; f0 += kCams) {
    const int fc = min(kCams, f - f0);
    stage_cameras(cams, prm, f0, fc);
    for (int j = 0; j < fc; ++j) {
      int lo_x = INT_MAX, lo_y = INT_MAX, hi_x = INT_MIN, hi_y = INT_MIN;
      if (active) {
        const Hit hit = project(x, y, z, load_params(cams + kParams * j), h, w);
        if (hit.valid && hit.z < __int_as_float(kInfBits)) {
          lo_x = hi_x = hit.px;
          lo_y = hi_y = hit.py;
        }
      }
      // every lane of every warp takes part: the inactive ones with the
      // identities of min and max
      lo_x = __reduce_min_sync(0xffffffffu, lo_x);
      lo_y = __reduce_min_sync(0xffffffffu, lo_y);
      hi_x = __reduce_max_sync(0xffffffffu, hi_x);
      hi_y = __reduce_max_sync(0xffffffffu, hi_y);
      if (lane == 0) {
        part[warp][0] = lo_x;
        part[warp][1] = lo_y;
        part[warp][2] = hi_x;
        part[warp][3] = hi_y;
      }
      __syncthreads();
      if (threadIdx.x < 4) {
        const int c = threadIdx.x;
        int v = part[0][c];
        for (int k = 1; k < kWarps; ++k) v = c < 2 ? min(v, part[k][c]) : max(v, part[k][c]);
        int* out = box + 4 * (f0 + j) + c;
        // a block whose points fill nothing of this frame leaves it alone
        if (c < 2 && v != INT_MAX) atomicMin(out, v);
        if (c >= 2 && v != INT_MIN) atomicMax(out, v);
      }
      __syncthreads();  // part is written again for the next frame
    }
  }
}

int blocks_for(long long count) { return static_cast<int>((count + kThreads - 1) / kThreads); }

// the fill is a grid-stride loop of int4 stores: eight blocks for each of the
// card's 132 SMs at most, fewer where the buffers are small
int fill_blocks(long long count) {
  const int b = blocks_for((count + 3) / 4);
  return b < 132 * 8 ? b : 132 * 8;
}

// this library links its own CUDA runtime, whose current device is set per
// host thread, so the entry sets it before each launch.
int set_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

int check_sizes(int n, int f, int h, int w) {
  if (n < 0 || f < 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" int mc_splat_depth(const void* pts, int n, const void* prm, int f, int h, int w,
                              void* zbuf, int device, void* stream) {
  if (const int err = check_sizes(n, f, h, w)) return err;
  if (f == 0) return 0;
  if (const int err = set_device(device)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long count = static_cast<long long>(f) * (static_cast<long long>(h) * w + 1);
  fill_kernel<<<fill_blocks(count), kThreads, 0, s>>>(static_cast<int*>(zbuf), count, kInfBits);
  if (n > 0) {
    splat_depth_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(pts), n, static_cast<const float*>(prm), f, h, w,
        static_cast<int*>(zbuf));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mc_splat_color(const void* pts, const void* colors, int n, const void* prm, int f,
                              int h, int w, const void* zbuf, void* codebuf, void* visible,
                              int device, void* stream) {
  if (const int err = check_sizes(n, f, h, w)) return err;
  if (f == 0) return 0;
  if (const int err = set_device(device)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(int) * static_cast<size_t>(f) *
                       (static_cast<size_t>(h) * static_cast<size_t>(w) + 1);
  if (const cudaError_t err = cudaMemsetAsync(codebuf, 0, bytes, s)) return static_cast<int>(err);
  if (n > 0) {
    splat_color_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(pts), static_cast<const float*>(colors), n,
        static_cast<const float*>(prm), f, h, w, static_cast<const int*>(zbuf),
        static_cast<int*>(codebuf), static_cast<uint8_t*>(visible));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mc_splat_bbox(const void* pts, int n, const void* prm, int f, int h, int w,
                             void* box, int device, void* stream) {
  if (const int err = check_sizes(n, f, h, w)) return err;
  if (f == 0) return 0;
  if (const int err = set_device(device)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  box_init_kernel<<<blocks_for(4LL * f), kThreads, 0, s>>>(static_cast<int*>(box), f);
  if (n > 0) {
    splat_bbox_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(pts), n, static_cast<const float*>(prm), f, h, w,
        static_cast<int*>(box));
  }
  return static_cast<int>(cudaGetLastError());
}
