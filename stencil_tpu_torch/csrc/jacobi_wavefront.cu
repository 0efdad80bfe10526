// The m-level Jacobi wavefront kernel for Hopper (sm_90a), bound to Python
// through ctypes (stencil_tpu_torch/kernels/build.py,
// stencil_tpu_torch/ops/jacobi_kernels.py).  One kernel body serves both
// TPU kernels it replaces:
//
//   stencil_tpu/ops/jacobi_pallas.py:983  jacobi_shell_wavefront_step
//     m levels over an s-shelled (Xr, Yr, Zr) block; z columns [0, s) and
//     [z_valid - s, z_valid) optionally from a z-major (Xr, 2s, Yr) slab
//     buffer, and then the next slabs emitted (kRing = false);
//   stencil_tpu/ops/jacobi_pallas.py:1204 jacobi_zring_wavefront_step
//     m levels over an (Xr, Yr, Zi) block with no z shell in the array, the
//     z halo from the slab buffer, d2 in the (Yr, Zi + 128) ring layout
//     (kRing = true).
//
// Both kernels' defining property is kept: m levels in ONE pass, each input
// plane read once and each output plane written once per m iterations.
//
// The same body without the sphere clamp (kClamp = false: no d2 tile, no
// sphere test, one plane of shared memory fewer) replaces
//
//   stencil_tpu/ops/plane_stencil.py:20   mean6_shell_wavefront_step
//     m <= s mean-of-6 levels over an s-shelled (Xr, Yr, Zr) block, valid on
//     the interior [s, ext - s); exported as stp_mean6_wavefront.
//
// The Jacobi instantiations (kClamp = true) are the code they were.
//
// Layout.  Each block works on a "logical plane" of width W: the raw columns
// (shell form: W = z_valid) or low halo | interior | high halo (ring form:
// W = Zi + 2s, logical column c = raw column c - s).  The TPU kernels' lane
// ring (hi halo at lanes [0,s), lo halo at [128-s,128)) is a TPU layout
// trick; only the d2 indexing follows it here.  A block owns a kTileY x
// (kTileW - 2m) tile of the plane's interior [s, Yr-s) x [s, W-s) and loads
// it with an m-cell apron, so a tile row with its apron is kTileW = 64
// columns, two full warps.  It marches x: per step it loads level-0 plane i
// and computes level l of plane i-l for l = 1..m over the tile shrunk by l,
// so level m lands exactly on the tile.  Shared memory per block:
//
//   (2m + 2) planes of (kTileY + 2m) x kTileW 4-byte cells
//   = 2m + 1 working planes (two level-l planes for l < m, kept as the TPU
//   kernel's VMEM ring (m, 2, Yr, Zr) keeps whole planes, plus the incoming
//   one) and the block's d2 tile.  m = 8: 221,184 B, the deepest that fits
//   the H100's 232,448 B opt-in; wavefront_smem_bytes in
//   ops/jacobi_kernels.py is the same formula, so the plan never asks more.
//   Without the clamp the d2 tile goes: 2m + 1 planes, 208,896 B at m = 8
//   (m = 9 would need 243,200 B, so kMaxM = 8 holds for both).
//
// A level's result overwrites the oldest plane of the level below in place:
// the thread that writes cell k read that plane only at k, just before.
//
// Bound on an H100 SXM: bytes.  Per macro step of m levels the kernel must
// read the input and the slabs and write the output and the new slabs once
// (8 B/cell plus the thin slabs), 8/m B per cell-level.  This simple design
// pays instead in shared-memory traffic (six neighbour loads, the d2 load on
// planes a sphere reaches, and one store per cell and level, over tiles
// grown by the apron) and in m + 1 block barriers per plane.  The next
// plane's global loads are issued into registers before the current plane's
// levels run, so their latency hides behind the levels.  Register-held x
// neighbours, fewer barriers, TMA loads and a persistent grid are later
// work.
//
// Cells outside the valid region (the apron beyond the plane's edge, the x
// planes before the march has filled the levels) hold garbage that only ever
// feeds other such cells, the shrinking-validity argument of the TPU kernel
// (jacobi_pallas.py:1034-1038): only the block interior [s, ext-s) of `out`
// and the interior x planes / y rows of `zout` are written.
//
// Bitwise contract with the JAX package, as csrc/jacobi.cu: the six
// neighbours summed as a left fold x-1, x+1, y-1, y+1, z-1, z+1; the mean a
// multiply by 0x1.555556p-3f; built without fast-math and with --fmad=false;
// the integer sphere test d2 < in_r2 - (x_g - c)^2 with
// x_g = (origin_x + gx + p - s) mod gx for raw plane p (skipped where the
// right side is <= 0: d2, a squared distance, is never negative).  Offsets
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSixth = 0x1.555556p-3f;  // == np.float32(1 / 6)
constexpr float kHot = 1.0f;
constexpr float kCold = 0.0f;
constexpr int kTileY = 32;  // == WAVEFRONT_TILE_Y in ops/jacobi_kernels.py
constexpr int kTileW = 64;  // == WAVEFRONT_TILE_W: tile columns with the apron
constexpr int kThreadsZ = 32;
constexpr int kThreadsY = 16;
constexpr int kRingOff = 128;  // == _ZRING_OFF
// the deepest m whose block fits the 232,448 B opt-in (wavefront_smem_fits);
// the kernel is instantiated for every m up to it, so tile extents, loop
// counts and the slot bookkeeping are compile-time and stay in registers
constexpr int kMaxM = 8;
constexpr int kFar = 1 << 30;  // d2 of cells off the plane: inside no sphere

struct Args {
  const float* raw;     // (n, Xr, Yr, Zraw)
  float* out;           // (n, Xr, Yr, Zraw)
  const int* origins;   // (n, 3)
  const int* d2;        // (n, Yr, d2_w)
  const float* zs;      // (n, Xr, 2s, Yr) or null
  float* zout;          // (n, Xr, 2s, Yr) or null
  int Xr, Yr, Zraw;
  int W;                // logical plane width
  int m, s;             // levels, interior offset (shell width)
  int d2_w;
  int gx, hot_x, cold_x, in_r2;
};

__device__ __forceinline__ int pmod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

template <int M, bool kRing, bool kSlabs, bool kClamp = true>
__global__ void __launch_bounds__(kThreadsZ * kThreadsY) wavefront(Args a) {
  extern __shared__ float smem[];
  constexpr int m = M;
  constexpr int H = kTileY + 2 * m;
  constexpr int TW = kTileW;
  constexpr int TZ = kTileW - 2 * m;  // output columns per tile
  constexpr int P = H * TW;
  // a thread's cells of the tile: rows ty0 + r*kThreadsY, columns tz0 + q*kThreadsZ
  constexpr int kRowIters = (H + kThreadsY - 1) / kThreadsY;
  constexpr int kColIters = (TW + kThreadsZ - 1) / kThreadsZ;
  const int s = a.s;
  int* d2t = reinterpret_cast<int*>(smem);
  float* pool = kClamp ? smem + P : smem;  // 2m + 1 planes
  const int b = blockIdx.z;
  // logical (row, column) of tile cell (0, 0); >= 0 since s >= m
  const int y0 = s + blockIdx.y * kTileY - m;
  const int c0 = s + blockIdx.x * TZ - m;
  const int col_off = kRing ? s : 0;
  const int Yr = a.Yr, W = a.W;
  const int64_t plane = (int64_t)Yr * a.Zraw;
  const float* __restrict__ raw = a.raw + (int64_t)b * a.Xr * plane;
  float* __restrict__ out = a.out + (int64_t)b * a.Xr * plane;
  const int64_t zplane = (int64_t)2 * s * Yr;
  const float* __restrict__ zs = kSlabs ? a.zs + (int64_t)b * a.Xr * zplane : nullptr;
  float* __restrict__ zout = kSlabs ? a.zout + (int64_t)b * a.Xr * zplane : nullptr;
  const int origin_x = kClamp ? a.origins[3 * b] : 0;
  const int tz0 = threadIdx.x, ty0 = threadIdx.y;

  // the block's d2 tile, in the layout the wrapper was given
  if constexpr (kClamp) {
    const int* d2 = a.d2 + (int64_t)b * Yr * a.d2_w;
    for (int ty = ty0; ty < H; ty += kThreadsY) {
      for (int tz = tz0; tz < TW; tz += kThreadsZ) {
        const int y = y0 + ty, c = c0 + tz;
        int v = kFar;
        if (y < Yr && c < W) {
          int col = c;
          if (kRing) col = c < W - s ? c - s + kRingOff : c - (W - s);
          v = d2[(int64_t)y * a.d2_w + col];
        }
        d2t[ty * TW + tz] = v;
      }
    }
  }

  // level-0 plane i of this thread's tile cells, into registers: issued one
  // plane ahead, so the loads fly while the levels of the plane before run
  float pre[kRowIters][kColIters];
  auto fetch = [&](int i) {
    const int64_t xo = (int64_t)i * plane;
#pragma unroll
    for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
      for (int q = 0; q < kColIters; ++q) {
        const int ty = ty0 + r * kThreadsY, tz = tz0 + q * kThreadsZ;
        const int y = y0 + ty, c = c0 + tz;
        float v = 0.0f;
        if (ty < H && tz < TW && y < Yr && c < W) {
          if (kSlabs && c < s) {
            v = zs[i * zplane + (int64_t)c * Yr + y];
          } else if (kSlabs && c >= W - s) {
            v = zs[i * zplane + (int64_t)(s + c - (W - s)) * Yr + y];
          } else {
            v = raw[xo + (int64_t)y * a.Zraw + (c - col_off)];
          }
        }
        pre[r][q] = v;
      }
    }
  };

  // slot bookkeeping (the same in every thread): older[l] / newer[l] hold
  // the two most recent level-l planes, free the slot the next load fills
  int older[m], newer[m];
#pragma unroll
  for (int l = 0; l < m; ++l) {
    older[l] = 2 * l;
    newer[l] = 2 * l + 1;
  }
  int free_slot = 2 * m;

  // output plane p = i - m needs level-0 planes p-m .. p+m: start where the
  // first interior plane s can be produced, stop after the last one
  const int i0 = s - m;
  const int i_end = a.Xr - s + m;
  fetch(i0);
  for (int i = i0; i < i_end; ++i) {
    float* in = pool + free_slot * P;
#pragma unroll
    for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
      for (int q = 0; q < kColIters; ++q) {
        const int ty = ty0 + r * kThreadsY, tz = tz0 + q * kThreadsZ;
        if (ty < H && tz < TW) in[ty * TW + tz] = pre[r][q];
      }
    }
    __syncthreads();
    if (i + 1 < i_end) fetch(i + 1);
    int cur = free_slot;  // the level-(l-1) plane i-l+1
#pragma unroll
    for (int l = 1; l <= m; ++l) {
      // three distinct slots: the compiler may batch their loads
      float* __restrict__ prev = pool + older[l - 1] * P;  // level l-1, plane i-l-1
      const float* __restrict__ cent = pool + newer[l - 1] * P;  // plane i-l
      const float* __restrict__ next = pool + cur * P;  // plane i-l+1
      const int p = i - l;  // raw plane of this level's result
      int hot_lim = 0, cold_lim = 0;
      bool spheres = false;
      if constexpr (kClamp) {
        const int x_g = pmod(origin_x + a.gx + p - s, a.gx);
        hot_lim = a.in_r2 - (x_g - a.hot_x) * (x_g - a.hot_x);
        cold_lim = a.in_r2 - (x_g - a.cold_x) * (x_g - a.cold_x);
        spheres = hot_lim > 0 || cold_lim > 0;
      }
      const bool last = l == m;
#pragma unroll
      for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
        for (int q = 0; q < kColIters; ++q) {
          const int ty = ty0 + l + r * kThreadsY, tz = tz0 + l + q * kThreadsZ;
          if (ty >= H - l || tz >= TW - l) continue;
          const int k = ty * TW + tz;
          float sum = prev[k] + next[k];  // x-1, x+1
          sum = sum + cent[k - TW];       // y-1
          sum = sum + cent[k + TW];       // y+1
          sum = sum + cent[k - 1];        // z-1
          sum = sum + cent[k + 1];        // z+1
          float v = sum * kSixth;
          if (kClamp && spheres) {  // d2 >= 0: no clamp can fire on this plane otherwise
            const int d = d2t[k];
            if (d < hot_lim) v = kHot;
            if (d < cold_lim) v = kCold;
          }
          if (!last) {
            prev[k] = v;  // this thread read prev only at k, just above
            continue;
          }
          const int y = y0 + ty, c = c0 + tz;
          if (p < s || y >= Yr - s || c >= W - s) continue;
          out[(int64_t)p * plane + (int64_t)y * a.Zraw + (c - col_off)] = v;
          if (kSlabs) {
            // rows [0, s): top interior columns (the -z-bound message);
            // rows [s, 2s): bottom interior columns (+z-bound)
            if (c >= W - 2 * s) zout[p * zplane + (int64_t)(c - (W - 2 * s)) * Yr + y] = v;
            if (c < 2 * s) zout[p * zplane + (int64_t)c * Yr + y] = v;
          }
        }
      }
      __syncthreads();
      // level l-1 slides by one plane; the overwritten slot now holds level
      // l's plane i-l (or, at l == m, nothing anyone reads)
      const int written = older[l - 1];
      older[l - 1] = newer[l - 1];
      newer[l - 1] = cur;
      cur = written;
    }
    free_slot = cur;
  }
}

template <int M, bool kRing, bool kSlabs, bool kClamp = true>
int launch(const Args& a, int n, cudaStream_t stream) {
  constexpr int TZ = kTileW - 2 * M;
  constexpr size_t smem = (size_t)(kClamp ? 2 * M + 2 : 2 * M + 1) * (kTileY + 2 * M) * kTileW * 4;
  cudaError_t err = cudaFuncSetAttribute(wavefront<M, kRing, kSlabs, kClamp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int interior_y = a.Yr - 2 * a.s, interior_z = a.W - 2 * a.s;
  dim3 grid((interior_z + TZ - 1) / TZ, (interior_y + kTileY - 1) / kTileY, n);
  wavefront<M, kRing, kSlabs, kClamp><<<grid, dim3(kThreadsZ, kThreadsY), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int M>
int launch_form(const Args& a, int n, bool ring, cudaStream_t stream) {
  if (ring) return launch<M, true, true>(a, n, stream);
  if (a.zs != nullptr) return launch<M, false, true>(a, n, stream);
  return launch<M, false, false>(a, n, stream);
}

}  // namespace

extern "C" {

// ring: 1 = jacobi_zring_wavefront_step (slabs required), 0 = the shell form
// (slabs optional: zs and zout both null or both set).  Returns a CUDA error
// code, or -1 for arguments the kernel does not take.
int stp_jacobi_wavefront(const float* raw, float* out, const int* origins, const int* d2,
                         const float* zs, float* zout, int n, int Xr, int Yr, int Zraw, int W,
                         int m, int s, int d2_w, int gx, int hot_x, int cold_x, int in_r2,
                         int ring, void* stream) {
  if (m < 1 || m > kMaxM || m > s || n < 1 || n > 65535 || 2 * s >= Yr || 2 * s >= W ||
      (zs == nullptr) != (zout == nullptr) || (ring && zs == nullptr))
    return -1;
  Args a{raw, out, origins, d2, zs, zout, Xr, Yr, Zraw, W, m, s, d2_w, gx, hot_x, cold_x, in_r2};
  cudaStream_t st = (cudaStream_t)stream;
  switch (m) {
    case 1: return launch_form<1>(a, n, ring, st);
    case 2: return launch_form<2>(a, n, ring, st);
    case 3: return launch_form<3>(a, n, ring, st);
    case 4: return launch_form<4>(a, n, ring, st);
    case 5: return launch_form<5>(a, n, ring, st);
    case 6: return launch_form<6>(a, n, ring, st);
    case 7: return launch_form<7>(a, n, ring, st);
    default: return launch_form<kMaxM>(a, n, ring, st);
  }
}

// m mean-of-6 levels over n s-shelled blocks (Xr, Yr, Zr): only the interior
// [s, ext - s) of `out` is written.  Returns a CUDA error code, or -1 for
// arguments the kernel does not take.
int stp_mean6_wavefront(const float* raw, float* out, int n, int Xr, int Yr, int Zr, int m, int s,
                        void* stream) {
  if (m < 1 || m > kMaxM || m > s || n < 1 || n > 65535 || 2 * s >= Xr || 2 * s >= Yr ||
      2 * s >= Zr)
    return -1;
  Args a{raw, out, nullptr, nullptr, nullptr, nullptr, Xr, Yr, Zr, Zr, m, s, 0, 1, 0, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  switch (m) {
    case 1: return launch<1, false, false, false>(a, n, st);
    case 2: return launch<2, false, false, false>(a, n, st);
    case 3: return launch<3, false, false, false>(a, n, st);
    case 4: return launch<4, false, false, false>(a, n, st);
    case 5: return launch<5, false, false, false>(a, n, st);
    case 6: return launch<6, false, false, false>(a, n, st);
    case 7: return launch<7, false, false, false>(a, n, st);
    default: return launch<kMaxM, false, false, false>(a, n, st);
  }
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
