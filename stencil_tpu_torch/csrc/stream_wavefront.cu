// m levels of a traced user kernel over s-shell blocks in ONE pass, for
// Hopper (sm_90a), bound to Python through ctypes
// (stencil_tpu_torch/kernels/build.py, stencil_tpu_torch/ops/stream.py).
//
// A kernel template: the line `// @STP_GENERATED@` below is replaced by the
// body that stencil_tpu_torch/ops/stream_trace.py emits for one user kernel
// (STP_NF, the field count; STP_M, the depth this library runs; stp_body,
// the kernel's arithmetic), and the result is built by nvcc into a library of
// its own, one per depth.
//
// stp_stream_wavefront replaces stencil_tpu/ops/stream.py:481
//   stream_wavefront_pass: m levels (read radius 1) of a user kernel over n
//   (Xr, Yr, Zr) blocks per field that carry an s-wide filled shell (m <= s);
//   validity shrinks by one cell per level.  In the z-slab form the z columns
//   [0, s) and [W - s, W) come from a z-major (Xr, 2s, Yr) slab buffer per
//   field and the next slabs are emitted (kSlabs = true); W = z_valid, and
//   columns [W, Zr) are dead.
//
// The design is csrc/jacobi_wavefront.cu's, with N fields and the emitted
// body in place of the Jacobi arithmetic.  A block owns a kTileY x
// (kTileW - 2m) tile of the plane interior [s, Yr-s) x [s, W-s) for one block
// b and one chunk of output x planes, loads it with an m-cell apron (a tile
// row with its apron is kTileW = 64 columns, two full warps) and marches x:
// per step it loads level-0 plane i of every field and computes level l of
// plane i-l for l = 1..m over the tile shrunk by l, so level m lands exactly
// on the tile.  Shared memory per block:
//
//   STP_NF x (2m + 2) planes of (kTileY + 2m) x kTileW 4-byte cells
//
// per field: the two most recent planes of each level below m (the TPU
// kernel's (m, 2, Yr, Zr) VMEM ring, tiled), the incoming level-0 plane and
// one spare plane that each level's result goes to.  Unlike the Jacobi
// kernel, a level may not overwrite the plane it reads: a user kernel can
// read x-1 at in-plane offsets (a 27-point stencil does), which a
// neighbouring thread may already have overwritten.  m = 3, one field:
// 77,824 B; stream_smem_bytes in ops/stream.py is the same formula, so the
// plan never asks for more than the H100's 232,448 B opt-in.
//
// Blocks march disjoint chunks of output planes [p_lo, p_hi), each starting
// m planes early, so a single subdomain still fills the card (about four
// blocks per SM); the chunking changes no value.
//
// Bound on an H100 SXM: bytes.  Per pass of m levels the kernel must read the
// input and the slabs and write the output and the new slabs once, 8/m B per
// cell-level and field.  This simple design pays instead in shared-memory
// traffic and m + 1 block barriers per plane; the next plane's global loads
// are issued into registers before the current plane's levels run.
//
// Cells outside the valid region (the apron beyond the plane's edge, which
// loads 0 and never leaves the block's memory; planes before the march has
// filled the levels) hold garbage that only ever feeds other such cells, the
// shrinking-validity argument of the TPU kernel: only the block interior
// [s, ext-s) of `out` and the interior x planes / y rows of `zout` are
// written.
//
// Bitwise contract: stp_body uses __fadd_rn/__fmul_rn/... (no contraction);
// the global coordinates are (origin + index - s) mod global size, as
// _yz_coord_planes computes them in the JAX package.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

// @STP_GENERATED@

namespace {

constexpr int kTileY = 32;  // == STREAM_TILE_Y in ops/stream.py
constexpr int kTileW = 64;  // == STREAM_TILE_W: tile columns with the apron
constexpr int kThreadsZ = 32;
constexpr int kThreadsY = 16;
constexpr int kBlocksPerSm = 4;  // chunk x until the grid has this many blocks per SM

struct Args {
  const float* raw[STP_NF];  // (n, Xr, Yr, Zr) each
  float* out[STP_NF];
  const float* zs[STP_NF];   // (n, Xr, 2s, Yr) each, or null
  float* zout[STP_NF];
  const int* origins;        // (n, 3)
  int Xr, Yr, Zr;
  int W;                     // logical plane width (z_valid)
  int s;                     // shell width
  int gx, gy, gz;
  int xchunk, nchunks;       // output x planes per block, chunks per block b
};

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

template <int M, bool kSlabs>
__global__ void __launch_bounds__(kThreadsZ * kThreadsY) wavefront(Args a) {
  extern __shared__ float smem[];
  constexpr int m = M;
  constexpr int H = kTileY + 2 * m;
  constexpr int TW = kTileW;
  constexpr int TZ = kTileW - 2 * m;  // output columns per tile
  constexpr int P = H * TW;
  constexpr int NS = 2 * m + 2;       // planes per field
  constexpr int kRowIters = (H + kThreadsY - 1) / kThreadsY;
  constexpr int kColIters = (TW + kThreadsZ - 1) / kThreadsZ;
  const int s = a.s;
  const int b = blockIdx.z / a.nchunks;
  const int chunk = blockIdx.z - b * a.nchunks;
  const int p_lo = s + chunk * a.xchunk;
  const int p_hi = min(p_lo + a.xchunk, a.Xr - s);
  // tile cell (0, 0) at row y0, column c0; >= 0 since s >= m
  const int y0 = s + blockIdx.y * kTileY - m;
  const int c0 = s + blockIdx.x * TZ - m;
  const int Yr = a.Yr, W = a.W, Zr = a.Zr;
  const int64_t plane = (int64_t)Yr * Zr;
  const int64_t zplane = (int64_t)2 * s * Yr;
  const int64_t bo = (int64_t)b * a.Xr * plane;
  const int64_t zbo = (int64_t)b * a.Xr * zplane;
  const int ox = a.origins[3 * b], oy = a.origins[3 * b + 1], oz = a.origins[3 * b + 2];
  const int tz0 = threadIdx.x, ty0 = threadIdx.y;

  // level-0 plane i of this thread's tile cells, into registers: issued one
  // plane ahead, so the loads fly while the levels of the plane before run
  float pre[STP_NF][kRowIters][kColIters];
  auto fetch = [&](int i) {
    const int64_t xo = bo + (int64_t)i * plane;
#pragma unroll
    for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
      for (int c = 0; c < kColIters; ++c) {
        const int ty = ty0 + r * kThreadsY, tz = tz0 + c * kThreadsZ;
        const int y = y0 + ty, col = c0 + tz;
        const bool in = ty < H && tz < TW && y < Yr && col < W;
#pragma unroll
        for (int q = 0; q < STP_NF; ++q) {
          float v = 0.0f;
          if (in) {
            if (kSlabs && col < s) {
              v = a.zs[q][zbo + i * zplane + (int64_t)col * Yr + y];
            } else if (kSlabs && col >= W - s) {
              v = a.zs[q][zbo + i * zplane + (int64_t)(s + col - (W - s)) * Yr + y];
            } else {
              v = a.raw[q][xo + (int64_t)y * Zr + col];
            }
          }
          pre[q][r][c] = v;
        }
      }
    }
  };

  // slot bookkeeping (the same in every thread and field): older[l] / newer[l]
  // hold the two most recent level-l planes; `in_slot` takes the next load,
  // `spare` the next level's result
  int older[m], newer[m];
#pragma unroll
  for (int l = 0; l < m; ++l) {
    older[l] = 2 * l;
    newer[l] = 2 * l + 1;
  }
  int in_slot = 2 * m, spare = 2 * m + 1;

  // output plane p = i - m needs level-0 planes p-m .. p+m
  const int i0 = p_lo - m;
  const int i_end = p_hi + m;
  fetch(i0);
  for (int i = i0; i < i_end; ++i) {
#pragma unroll
    for (int q = 0; q < STP_NF; ++q) {
      float* dst = smem + (q * NS + in_slot) * P;
#pragma unroll
      for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
        for (int c = 0; c < kColIters; ++c) {
          const int ty = ty0 + r * kThreadsY, tz = tz0 + c * kThreadsZ;
          if (ty < H && tz < TW) dst[ty * TW + tz] = pre[q][r][c];
        }
      }
    }
    __syncthreads();
    if (i + 1 < i_end) fetch(i + 1);
    int cur = in_slot;  // the level-(l-1) plane i-l+1
#pragma unroll
    for (int l = 1; l <= m; ++l) {
      const int p = i - l;  // raw plane of this level's result
      const int xg = pmod(ox + p - s, a.gx);
      const bool last = l == m;
      const int s_old = older[l - 1], s_new = newer[l - 1];
#pragma unroll
      for (int r = 0; r < kRowIters; ++r) {
#pragma unroll
        for (int c = 0; c < kColIters; ++c) {
          const int ty = ty0 + l + r * kThreadsY, tz = tz0 + l + c * kThreadsZ;
          if (ty >= H - l || tz >= TW - l) continue;
          const int k = ty * TW + tz;
          const int y = y0 + ty, col = c0 + tz;
          auto ld = [&](int q, int dx, int dy, int dz) -> float {
            const int slot = dx < 0 ? s_old : (dx == 0 ? s_new : cur);
            return smem[(q * NS + slot) * P + k + dy * TW + dz];
          };
          float v[STP_NF];
          stp_body(ld, l, xg, pmod(oy + y - s, a.gy), pmod(oz + col - s, a.gz), v);
          if (!last) {
#pragma unroll
            for (int q = 0; q < STP_NF; ++q) smem[(q * NS + spare) * P + k] = v[q];
            continue;
          }
          if (p < p_lo || y >= Yr - s || col >= W - s) continue;
          const int64_t o = bo + (int64_t)p * plane + (int64_t)y * Zr + col;
#pragma unroll
          for (int q = 0; q < STP_NF; ++q) {
            a.out[q][o] = v[q];
            if (kSlabs) {
              // rows [0, s): top interior columns (the -z-bound message);
              // rows [s, 2s): bottom interior columns (+z-bound)
              const int64_t zo = zbo + (int64_t)p * zplane + y;
              if (col >= W - 2 * s) a.zout[q][zo + (int64_t)(col - (W - 2 * s)) * Yr] = v[q];
              if (col < 2 * s) a.zout[q][zo + (int64_t)col * Yr] = v[q];
            }
          }
        }
      }
      __syncthreads();
      // level l-1 slides by one plane; level l's plane i-l is in `spare`; the
      // dropped level-(l-1) plane's slot is free
      older[l - 1] = s_new;
      newer[l - 1] = cur;
      cur = spare;
      spare = s_old;
    }
    in_slot = cur;  // level m wrote no plane here: the slot is free
  }
}

template <int M, bool kSlabs>
int launch(Args a, int n, cudaStream_t stream) {
  constexpr int TZ = kTileW - 2 * M;
  constexpr size_t smem = (size_t)STP_NF * (2 * M + 2) * (kTileY + 2 * M) * kTileW * 4;
  cudaError_t err = cudaFuncSetAttribute(wavefront<M, kSlabs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ix = a.Xr - 2 * a.s, iy = a.Yr - 2 * a.s, iz = a.W - 2 * a.s;
  const int tiles = ((iz + TZ - 1) / TZ) * ((iy + kTileY - 1) / kTileY);
  // chunks of at least 8m planes, so the 2m-plane ramp of a chunk stays small
  const int want = (kBlocksPerSm * sms + tiles * n - 1) / (tiles * n);
  int xchunk = (ix + want - 1) / want;
  if (xchunk < 8 * M) xchunk = 8 * M;
  a.xchunk = xchunk;
  a.nchunks = (ix + xchunk - 1) / xchunk;
  if ((int64_t)n * a.nchunks > 65535) return -1;
  dim3 grid((iz + TZ - 1) / TZ, (iy + kTileY - 1) / kTileY, n * a.nchunks);
  wavefront<M, kSlabs><<<grid, dim3(kThreadsZ, kThreadsY), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int M>
int launch_form(const Args& a, int n, bool slabs, cudaStream_t stream) {
  return slabs ? launch<M, true>(a, n, stream) : launch<M, false>(a, n, stream);
}

}  // namespace

extern "C" {

// raw/out (and zs/zout with slabs = 1): host arrays of STP_NF device
// pointers; origins: (n, 3) int32 on the device.  Returns a CUDA error code,
// or -1 for arguments the kernel does not take.
int stp_stream_wavefront(void* const* raw, void* const* out, void* const* zs, void* const* zout,
                         const int* origins, int n, int Xr, int Yr, int Zr, int W, int m, int s,
                         int gx, int gy, int gz, int slabs, void* stream) {
  if (m != STP_M || m > s || n < 1 || 2 * s >= Xr || 2 * s >= Yr || 2 * s >= W ||
      W > Zr || gx < 1 || gy < 1 || gz < 1 || (slabs && (zs == nullptr || zout == nullptr)))
    return -1;
  Args a;
  for (int q = 0; q < STP_NF; ++q) {
    a.raw[q] = static_cast<const float*>(raw[q]);
    a.out[q] = static_cast<float*>(out[q]);
    a.zs[q] = slabs ? static_cast<const float*>(zs[q]) : nullptr;
    a.zout[q] = slabs ? static_cast<float*>(zout[q]) : nullptr;
  }
  a.origins = origins;
  a.Xr = Xr;
  a.Yr = Yr;
  a.Zr = Zr;
  a.W = W;
  a.s = s;
  a.gx = gx;
  a.gy = gy;
  a.gz = gz;
  a.xchunk = a.nchunks = 0;
  return launch_form<STP_M>(a, n, slabs, (cudaStream_t)stream);
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
