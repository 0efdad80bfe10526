// One level of a traced user kernel over the whole periodic domain, for
// Hopper (sm_90a), bound to Python through ctypes
// (stencil_tpu_torch/kernels/build.py, stencil_tpu_torch/ops/stream.py).
//
// A kernel template: the line `// @STP_GENERATED@` below is replaced by the
// body that stencil_tpu_torch/ops/stream_trace.py emits for one user kernel
// (STP_NF, the field count, and stp_body, the kernel's arithmetic), and the
// result is built by nvcc into a library of its own.
//
// stp_stream_wrap_level replaces stencil_tpu/ops/stream.py:698
//   stream_wrap_pass: k levels of a user kernel over the whole single-
//   subdomain periodic (X, Y, Z) domain, for N fields of any storage the
//   generated part names (float, bf16 with float levels, double).  The TPU kernel
//   streams x-planes through a VMEM ring and runs k levels per pass; here one
//   launch is one level, for all N fields, and the wrapper ping-pongs k
//   launches between two sets of buffers, as csrc/jacobi.cu does for
//   jacobi_wrap_step.
//
// Bound on an H100 SXM: bytes.  A level reads each field's cells once and
// writes them once, 8 B per cell and field.  The design is the simple one:
// one thread per (y, z) column of a plane, z on threadIdx.x so a warp reads
// 128 contiguous bytes per neighbour, neighbour re-reads left to L1/L2, every
// index wrapped periodically (x by plane index, y and z in-plane), so no read
// leaves the domain.  Temporal blocking in shared memory is later work.
//
// Field dtypes (the generated part's STP_S, STP_C and access macros,
// ops/stream_trace.py): a level reads each field at its compute type STP_C
// and stores it back.  The JAX pass rounds a bf16-stored field once per
// call of k levels (its f32 level rings, stencil_tpu/ops/stream.py:772-773),
// so under bf16 storage (STP_S != STP_C) the wrapper's first launch reads
// the bf16 fields and writes a float scratch, the middle launches go float
// to float, and the last writes bf16 (in_acc / out_acc pick the buffers'
// types; k = 1 goes bf16 to bf16): wrap_level<TI, TO> for each pair, built
// where the generated part defines STP_SCRATCH.  Other storages compute at
// their own types and take <STP_S, STP_S> only.
//
// The contraction form (compute_unit "mxu" / "mxu_band": the generated
// part defines STP_NBR_MASK, the fields whose centre plane a level
// contracts, and STP_MXU, 1 for f32 operands as three TF32 pieces, 2 for
// bf16 operands; its stp_body reads a field's in-plane neighbour sum
// (y-1 + y+1) + (z-1 + z+1) through nb(q), the PlaneView.plane_nbr_sum
// seam of stencil_tpu/ops/stream.py:189-200): wrap_level_mxu.  A block of 8
// warps owns a 30 x 62 tile of (y, z) and walks x; per plane it stages each
// such field's 32 x 64 tile with a one-cell apron (indices wrapped, as the
// JAX pass's contraction is periodic over the whole plane) in shared memory
// at the compute type, contracts it on the tensor cores, one 16 x 16 piece a
// warp (csrc/band_mma.cuh), into a shared plane of sums per field, and then
// runs the per-cell body, its plane reads from global memory as above.
//
// Bitwise contract: stp_body uses __fadd_rn/__fmul_rn/... (no contraction);
// the global coordinates are (origin + index) mod global size, as
// _yz_coord_planes computes them in the JAX package.  The contraction form
// holds within tests/ulp.py's 4 ulps a level of its plain version (the
// tensor core's accumulation of the in-plane sums).

#include <cuda_runtime.h>
#include <stdint.h>

// @STP_GENERATED@

#ifdef STP_NBR_MASK
#include "band_mma.cuh"
#endif

namespace {

constexpr int kTileZ = 32;
constexpr int kTileY = 8;
constexpr int kMaxGridZ = 65535;

template <class TI, class TO>
struct Fields {
  const TI* in[STP_NF];
  TO* out[STP_NF];
};

// grid: (ceil(Z/32), ceil(Y/8), min(X, 65535)); x strides by gridDim.z
template <class TI, class TO>
__global__ void wrap_level(Fields<TI, TO> f, const int* __restrict__ origin, int X, int Y, int Z,
                           int gx, int gy, int gz, int level) {
  const int z = blockIdx.x * kTileZ + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (z >= Z || y >= Y) return;
  const int64_t plane = (int64_t)Y * Z;
  const int ys[3] = {y == 0 ? Y - 1 : y - 1, y, y == Y - 1 ? 0 : y + 1};
  const int zs[3] = {z == 0 ? Z - 1 : z - 1, z, z == Z - 1 ? 0 : z + 1};
  const int yg = (origin[1] + y) % gy;
  const int zg = (origin[2] + z) % gz;
  for (int x = blockIdx.z; x < X; x += gridDim.z) {
    const int xs[3] = {x == 0 ? X - 1 : x - 1, x, x == X - 1 ? 0 : x + 1};
    const int xg = (origin[0] + x) % gx;
    auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
      return STP_LD(f.in[q], q, (int64_t)xs[dx + 1] * plane + (int64_t)ys[dy + 1] * Z + zs[dz + 1]);
    };
    STP_C out[STP_NF];
    stp_body(ld, level, xg, yg, zg, out);
    const int64_t idx = (int64_t)x * plane + (int64_t)y * Z + z;
#pragma unroll
    for (int q = 0; q < STP_NF; ++q) STP_ST(f.out[q], q, idx, out[q]);
  }
}

#ifdef STP_NBR_MASK

constexpr int kSR = 32, kSC = 64;            // the staged tile, its one-cell apron included
constexpr int kOR = kSR - 2, kOC = kSC - 2;  // the cells a block computes
constexpr int kTile = kSR * kSC;
// a staging plane and one plane of sums a field
constexpr size_t kMxuSmem = (size_t)(1 + STP_NF) * kTile * sizeof(float);

__device__ __forceinline__ int wrap_index(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// grid: (ceil(Z/62), ceil(Y/30), min(X, 65535)), blocks of 32 x 8 threads;
// x strides by gridDim.z
template <class TI, class TO>
__global__ void __launch_bounds__(256) wrap_level_mxu(Fields<TI, TO> f, const int* __restrict__ origin, int X,
                                                      int Y, int Z, int gx, int gy, int gz, int level) {
  extern __shared__ __align__(16) float smem_mxu[];
  float* const stage = smem_mxu;
  float* const sums = smem_mxu + kTile;  // field q's plane at q * kTile
  const int y0 = blockIdx.y * kOR - 1, z0 = blockIdx.x * kOC - 1;  // tile cell (0, 0)
  const int64_t plane = (int64_t)Y * Z;
  for (int x = blockIdx.z; x < X; x += gridDim.z) {
    const int64_t po = (int64_t)x * plane;
#pragma unroll
    for (int q = 0; q < STP_NF; ++q) {
      if (!(STP_NBR_MASK >> q & 1)) continue;
      for (int r = threadIdx.y; r < kSR; r += kTileY)
        for (int c = threadIdx.x; c < kSC; c += kTileZ)
          stage[r * kSC + c] = STP_LD(f.in[q], q, po + (int64_t)wrap_index(y0 + r, Y) * Z + wrap_index(z0 + c, Z));
      __syncthreads();
      band_mma::piece_to_plane<STP_MXU, kSR, kSC, kSC, kSC>(stage, sums + q * kTile, threadIdx.y, threadIdx.x);
      __syncthreads();
    }
    const int xs[3] = {x == 0 ? X - 1 : x - 1, x, x == X - 1 ? 0 : x + 1};
    const int xg = (origin[0] + x) % gx;
    for (int r = 1 + threadIdx.y; r <= kOR && y0 + r < Y; r += kTileY) {
      const int y = y0 + r;
      const int ys[3] = {y == 0 ? Y - 1 : y - 1, y, y == Y - 1 ? 0 : y + 1};
      const int yg = (origin[1] + y) % gy;
      for (int c = 1 + threadIdx.x; c <= kOC && z0 + c < Z; c += kTileZ) {
        const int z = z0 + c;
        const int zs[3] = {z == 0 ? Z - 1 : z - 1, z, z == Z - 1 ? 0 : z + 1};
        const int zg = (origin[2] + z) % gz;
        auto ld = [&](int q, int dx, int dy, int dz) -> STP_C {
          return STP_LD(f.in[q], q, (int64_t)xs[dx + 1] * plane + (int64_t)ys[dy + 1] * Z + zs[dz + 1]);
        };
        auto nb = [&](int q) -> STP_C { return sums[q * kTile + r * kSC + c]; };
        STP_C out[STP_NF];
        stp_body(ld, nb, level, xg, yg, zg, out);
#pragma unroll
        for (int q = 0; q < STP_NF; ++q) STP_ST(f.out[q], q, po + (int64_t)y * Z + z, out[q]);
      }
    }
    __syncthreads();  // this plane's reads of the sums before the next plane's contraction
  }
}

#endif  // STP_NBR_MASK

template <class TI, class TO>
int launch(void* const* in, void* const* out, const int* origin, int X, int Y, int Z, int gx, int gy,
           int gz, int level, void* stream) {
  Fields<TI, TO> f;
  for (int q = 0; q < STP_NF; ++q) {
    f.in[q] = static_cast<const TI*>(in[q]);
    f.out[q] = static_cast<TO*>(out[q]);
  }
#ifdef STP_NBR_MASK
  const cudaError_t err =
      cudaFuncSetAttribute(wrap_level_mxu<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMxuSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Z + kOC - 1) / kOC, (Y + kOR - 1) / kOR, (unsigned)(X < kMaxGridZ ? X : kMaxGridZ));
  wrap_level_mxu<TI, TO><<<grid, dim3(kTileZ, kTileY), kMxuSmem, (cudaStream_t)stream>>>(f, origin, X, Y, Z, gx,
                                                                                          gy, gz, level);
#else
  dim3 grid((Z + kTileZ - 1) / kTileZ, (Y + kTileY - 1) / kTileY,
            (unsigned)(X < kMaxGridZ ? X : kMaxGridZ));
  wrap_level<TI, TO><<<grid, dim3(kTileZ, kTileY), 0, (cudaStream_t)stream>>>(f, origin, X, Y, Z, gx,
                                                                              gy, gz, level);
#endif
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in/out: host arrays of STP_NF device pointers, each an (X, Y, Z) field,
// of the storage type STP_S, or of the compute type STP_C where in_acc /
// out_acc is 1 (a float scratch under bf16 storage; both flags are moot
// where the two types are one); origin: 3 int32 on the device.  Returns a
// CUDA error code, or -1 for arguments the kernel does not take.
int stp_stream_wrap_level(void* const* in, void* const* out, const int* origin, int X, int Y,
                          int Z, int gx, int gy, int gz, int level, int in_acc, int out_acc, void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || gx < 1 || gy < 1 || gz < 1) return -1;
#ifdef STP_SCRATCH
  if (in_acc && out_acc) return launch<STP_C, STP_C>(in, out, origin, X, Y, Z, gx, gy, gz, level, stream);
  if (in_acc) return launch<STP_C, STP_S>(in, out, origin, X, Y, Z, gx, gy, gz, level, stream);
  if (out_acc) return launch<STP_S, STP_C>(in, out, origin, X, Y, Z, gx, gy, gz, level, stream);
#else
  (void)in_acc;
  (void)out_acc;
#endif
  return launch<STP_S, STP_S>(in, out, origin, X, Y, Z, gx, gy, gz, level, stream);
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
