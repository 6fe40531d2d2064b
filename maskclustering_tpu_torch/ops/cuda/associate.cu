// Dense projective association over a stack of frames: a per-pixel table,
// the claim and the assignment, one launch each a scene.
//
// Replaces the per-point work of the XLA program
// maskclustering_tpu/models/backprojection.py::associate_frame
// (:229-300 window claim, :319-335 distinct-claim counts, :347-353 the
// assignment against the valid masks), which _associate_scene_impl
// (:372-436) maps over the frames. Three entries:
//
//   mc_associate_table         one thread a pixel of the (F, H, W) depth and
//       id stacks: the masked depth d, the masked id s and the pixel's
//       backprojection qx = ((u - cx) * d) / fx, qy = ((v - cy) * d) / fy
//       (:264-265), as an (F, H, W) int4 table of float bits (qx, qy, d)
//       and the id. The two IEEE divisions are done once a pixel, not once
//       for each of the ~11 window visits a pixel gets at full size.
//   mc_associate_claim_scene   x a tile of 256 points, one thread a point,
//       y a group of kGroup frames. A block stages its points and its
//       frames' parameters in shared memory once and walks its frames one
//       after another: project, walk the (2w+1)^2 pixel window with one
//       16-byte table load a pixel, and count each distinct (point, mask)
//       pair once. Lanes of a warp that claim the same id are grouped with
//       __match_any_sync; the group's leader adds the group's size to the
//       frame's shared histogram of k_max + 1 int32 bins, merged into the
//       global (F, k_max + 1) counts with one atomic per non-zero bin.
//   mc_associate_assign_scene  the claim's grid, after mask_valid
//       (F, k_max + 1) is known: the same window again, the smallest /
//       largest valid claiming id and the unique id, written to the
//       scene's (F, N) planes.
//
// No candidate plane: the assignment walks the window again through the
// claim's own __device__ function, so the two round alike by construction.
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
// Bound: bytes. The table reads 8 B and writes 16 B a pixel. The claim and
// the assignment read the cloud once (12 B a point), the table (16 B a
// pixel) and the (F, 18) parameters; the claim writes (F, k_max + 1)
// counts, the assignment reads mask_valid and writes 8 B a point-frame.
// Their arithmetic, 24 FP32 operations a point-frame and 8 a window pixel
// that reaches the distance test, takes a fraction of that time on this
// card; what holds the walk back is latency and issue (scattered window
// gathers, a point-frame's two IEEE divisions).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 18;
constexpr unsigned kFull = 0xffffffffu;
// frames a block of the claim and the assignment walks: with one a block
// the grid is 1.5 waves of the card's 132 SMs at full size and measured
// 18 % slower than 4; 8 is within 3 % of 4 (PERF.md)
constexpr int kGroup = 4;
// ids are int16 in the outputs; the shared rows below hold k_max + 1
constexpr int kMaxId = 1023;

// params: rotation (row-major 9), translation (3), fx, fy, cx, cy, r2, depth_trunc
struct Params {
  float r[9];
  float t[3];
  float fx, fy, cx, cy, r2, trunc;
};

struct Scene {
  const float* pts;   // (N, 3)
  int n;
  const int4* table;  // (F, H, W): float bits of qx, qy, d; the id
  int frames, h, w;
  const float* prm;   // (F, 18)
  int k_max;
};

// shared memory of a claim or assignment block: its frames' parameters,
// its point tile, then one row of k_max + 1 elements of `row_elem` bytes
// a frame (at most 19.7 KB, under the 48 KB a block takes without opt-in)
constexpr size_t smem_bytes(int k_max, size_t row_elem) {
  return sizeof(float) * (kGroup * kParams + 3 * kThreads) +
         static_cast<size_t>(kGroup) * (k_max + 1) * row_elem;
}
static_assert(smem_bytes(kMaxId, sizeof(int)) <= 48 * 1024, "claim block over 48 KB");

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

// ((u - c) * d) / f: a pixel's backprojection on one axis, not contracted
__device__ __forceinline__ float backproject(int u, float c, float d, float f) {
  return __fdiv_rn(__fmul_rn(__fsub_rn(static_cast<float>(u), c), d), f);
}

// one thread a pixel, blockIdx.y the frame
__global__ void __launch_bounds__(kThreads)
table_kernel(const float* __restrict__ depth, const int* __restrict__ seg, int h, int w,
             const float* __restrict__ prm, int k_max, int4* __restrict__ table) {
  const int hw = h * w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= hw) return;
  const float* fp = prm + static_cast<size_t>(blockIdx.y) * kParams;
  const size_t o = static_cast<size_t>(blockIdx.y) * hw + i;
  const float raw = __ldg(depth + o);
  const float d = (raw > 0.0f && raw <= __ldg(fp + 17)) ? raw : 0.0f;
  const int rs = __ldg(seg + o);
  const int s = (rs < 0 || rs > k_max) ? 0 : rs;
  const int u = i % w, v = i / w;
  table[o] = make_int4(__float_as_int(backproject(u, __ldg(fp + 14), d, __ldg(fp + 12))),
                       __float_as_int(backproject(v, __ldg(fp + 15), d, __ldg(fp + 13))),
                       __float_as_int(d), s);
}

// The claiming ids of one point's window in one frame: ids[j] for window
// pixel (dv, du) = (j / (2W+1) - W, j % (2W+1) - W), 0 = no claim. The
// claim and the assignment both call this, so they round alike.
template <int W>
__device__ __forceinline__ void window_claims(float x, float y, float z, const Params& p,
                                              const Scene& a, size_t frame_off,
                                              int (&ids)[(2 * W + 1) * (2 * W + 1)]) {
  constexpr int WW = 2 * W + 1;
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
  const int uc = min(max(ui, 0), a.w - 1);
  const int vc = min(max(vi, 0), a.h - 1);
#pragma unroll
  for (int dv = -W; dv <= W; ++dv) {
#pragma unroll
    for (int du = -W; du <= W; ++du) {
      const int uu = uc + du, vv = vc + dv;
      int id = 0;
      if (in_front && uu >= 0 && uu < a.w && vv >= 0 && vv < a.h && wrap_abs_diff(uu, ui) <= W &&
          wrap_abs_diff(vv, vi) <= W) {
        const int4 t = __ldg(a.table + frame_off + static_cast<size_t>(vv) * a.w + uu);
        const float d = __int_as_float(t.z);
        if (d > 0.0f && t.w > 0) {
          const float ex = __fsub_rn(__int_as_float(t.x), px);
          const float ey = __fsub_rn(__int_as_float(t.y), py);
          const float ez = __fsub_rn(d, pz);
          const float dist2 = __fmaf_rn(ez, ez, __fmaf_rn(ex, ex, __fmul_rn(ey, ey)));
          if (dist2 <= p.r2) id = t.w;
        }
      }
      ids[(dv + W) * WW + (du + W)] = id;
    }
  }
}

// Stage the block's frame parameters and its tile of points in shared
// memory; returns the number of points in the tile.
__device__ __forceinline__ int stage(const Scene& a, int f0, int nf, float* sprm, float* tile) {
  for (int i = threadIdx.x; i < nf * kParams; i += kThreads)
    sprm[i] = __ldg(a.prm + static_cast<size_t>(f0) * kParams + i);
  const int base = blockIdx.x * kThreads;
  const int cnt = min(kThreads, a.n - base);
  const float* src = a.pts + 3 * static_cast<size_t>(base);
  for (int i = threadIdx.x; i < 3 * cnt; i += kThreads) tile[i] = __ldg(src + i);
  return cnt;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
claim_scene_kernel(Scene a, int* __restrict__ n_claimed) {
  constexpr int K = (2 * W + 1) * (2 * W + 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = a.k_max + 1;
  const int f0 = blockIdx.y * kGroup;
  const int nf = min(kGroup, a.frames - f0);
  float* sprm = reinterpret_cast<float*>(smem);
  float* tile = sprm + kGroup * kParams;
  int* hist = reinterpret_cast<int*>(tile + 3 * kThreads);
  for (int i = threadIdx.x; i < nf * nb; i += kThreads) hist[i] = 0;
  const int cnt = stage(a, f0, nf, sprm, tile);
  __syncthreads();

  const bool live = static_cast<int>(threadIdx.x) < cnt;
  const float x = live ? tile[3 * threadIdx.x] : 0.0f;
  const float y = live ? tile[3 * threadIdx.x + 1] : 0.0f;
  const float z = live ? tile[3 * threadIdx.x + 2] : 0.0f;
  const int lane = threadIdx.x & 31;
  const size_t hw = static_cast<size_t>(a.h) * a.w;
  for (int g = 0; g < nf; ++g) {
    const Params& p = *reinterpret_cast<const Params*>(sprm + g * kParams);
    int ids[K];
    if (live) {
      window_claims<W>(x, y, z, p, a, (f0 + g) * hw, ids);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) ids[j] = 0;
    }
    // each (point, mask) pair counts once: an id at its first slot only;
    // the lanes holding one id add to its bin once, through their leader
    int* row = hist + g * nb;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bool first = ids[j] > 0;
#pragma unroll
      for (int q = 0; q < j; ++q) first = first && ids[q] != ids[j];
      const int key = first ? ids[j] : 0;
      if (__any_sync(kFull, key > 0)) {
        const unsigned same = __match_any_sync(kFull, key);
        if (key > 0 && lane == __ffs(same) - 1) atomicAdd(row + key, __popc(same));
      }
    }
  }
  __syncthreads();
  int* out = n_claimed + static_cast<size_t>(f0) * nb;
  for (int i = threadIdx.x; i < nf * nb; i += kThreads) {
    const int v = hist[i];
    if (v) atomicAdd(out + i, v);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
assign_scene_kernel(Scene a, const uint8_t* __restrict__ valid, int* __restrict__ mop,
                    int16_t* __restrict__ first, int16_t* __restrict__ last) {
  constexpr int K = (2 * W + 1) * (2 * W + 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = a.k_max + 1;
  const int f0 = blockIdx.y * kGroup;
  const int nf = min(kGroup, a.frames - f0);
  float* sprm = reinterpret_cast<float*>(smem);
  float* tile = sprm + kGroup * kParams;
  uint8_t* svalid = reinterpret_cast<uint8_t*>(tile + 3 * kThreads);
  for (int i = threadIdx.x; i < nf * nb; i += kThreads)
    svalid[i] = __ldg(valid + static_cast<size_t>(f0) * nb + i);
  const int cnt = stage(a, f0, nf, sprm, tile);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= cnt) return;

  const float x = tile[3 * threadIdx.x], y = tile[3 * threadIdx.x + 1],
              z = tile[3 * threadIdx.x + 2];
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t hw = static_cast<size_t>(a.h) * a.w;
  for (int g = 0; g < nf; ++g) {
    const Params& p = *reinterpret_cast<const Params*>(sprm + g * kParams);
    int ids[K];
    window_claims<W>(x, y, z, p, a, (f0 + g) * hw, ids);
    const uint8_t* vrow = svalid + g * nb;
    int lo = a.k_max + 1, hi = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = ids[j];
      if (c > 0 && vrow[c]) {
        lo = min(lo, c);
        hi = max(hi, c);
      }
    }
    const bool any = hi > 0;
    lo = any ? lo : 0;
    const size_t o = static_cast<size_t>(f0 + g) * a.n + i;
    mop[o] = (any && lo == hi) ? lo : 0;
    first[o] = static_cast<int16_t>(lo);
    last[o] = static_cast<int16_t>(hi);
  }
}

// The scene of a claim or assignment call and its grid: point tiles x
// frame groups.
bool scene_of(const void* pts, int n, const void* table, int frames, int h, int w,
              const void* prm, int k_max, Scene* a, dim3* grid) {
  if (k_max < 1 || k_max > kMaxId) return false;
  *a = Scene{static_cast<const float*>(pts), n, static_cast<const int4*>(table), frames, h, w,
             static_cast<const float*>(prm), k_max};
  *grid = dim3((n + kThreads - 1) / kThreads, (frames + kGroup - 1) / kGroup);
  return true;
}

// Every entry launches on card `device`, the ordinal of its tensors' card:
// this library links its own CUDA runtime, whose current device is set per
// host thread, so the entry sets it before each launch.
int set_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

}  // namespace

extern "C" int mc_associate_table(const void* depth, const void* seg, int frames, int h, int w,
                                  const void* prm, int k_max, void* table, int device,
                                  void* stream) {
  if (frames <= 0 || h * w <= 0) return 0;
  if (const int err = set_device(device)) return err;
  const dim3 grid((h * w + kThreads - 1) / kThreads, frames);
  table_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const int*>(seg), h, w,
      static_cast<const float*>(prm), k_max, static_cast<int4*>(table));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mc_associate_claim_scene(const void* pts, int n, const void* table, int frames,
                                        int h, int w, const void* prm, int k_max, int window,
                                        void* n_claimed, int device, void* stream) {
  if (n <= 0 || frames <= 0) return 0;
  if (const int err = set_device(device)) return err;
  Scene a;
  dim3 grid;
  if (!scene_of(pts, n, table, frames, h, w, prm, k_max, &a, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k_max, sizeof(int));
  auto* s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<int*>(n_claimed);
  switch (window) {
    case 0: claim_scene_kernel<0><<<grid, kThreads, smem, s>>>(a, out); break;
    case 1: claim_scene_kernel<1><<<grid, kThreads, smem, s>>>(a, out); break;
    case 2: claim_scene_kernel<2><<<grid, kThreads, smem, s>>>(a, out); break;
    case 3: claim_scene_kernel<3><<<grid, kThreads, smem, s>>>(a, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mc_associate_assign_scene(const void* pts, int n, const void* table, int frames,
                                         int h, int w, const void* prm, const void* valid,
                                         int k_max, int window, void* mop, void* first,
                                         void* last, int device, void* stream) {
  if (n <= 0 || frames <= 0) return 0;
  if (const int err = set_device(device)) return err;
  Scene a;
  dim3 grid;
  if (!scene_of(pts, n, table, frames, h, w, prm, k_max, &a, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k_max, sizeof(uint8_t));
  auto* s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* mp = static_cast<int*>(mop);
  auto* fp = static_cast<int16_t*>(first);
  auto* lp = static_cast<int16_t*>(last);
  switch (window) {
    case 0: assign_scene_kernel<0><<<grid, kThreads, smem, s>>>(a, v, mp, fp, lp); break;
    case 1: assign_scene_kernel<1><<<grid, kThreads, smem, s>>>(a, v, mp, fp, lp); break;
    case 2: assign_scene_kernel<2><<<grid, kThreads, smem, s>>>(a, v, mp, fp, lp); break;
    case 3: assign_scene_kernel<3><<<grid, kThreads, smem, s>>>(a, v, mp, fp, lp); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
