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
// Bitwise contract: stp_body uses __fadd_rn/__fmul_rn/... (no contraction);
// the global coordinates are (origin + index) mod global size, as
// _yz_coord_planes computes them in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

// @STP_GENERATED@

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

template <class TI, class TO>
int launch(void* const* in, void* const* out, const int* origin, int X, int Y, int Z, int gx, int gy,
           int gz, int level, void* stream) {
  Fields<TI, TO> f;
  for (int q = 0; q < STP_NF; ++q) {
    f.in[q] = static_cast<const TI*>(in[q]);
    f.out[q] = static_cast<TO*>(out[q]);
  }
  dim3 grid((Z + kTileZ - 1) / kTileZ, (Y + kTileY - 1) / kTileY,
            (unsigned)(X < kMaxGridZ ? X : kMaxGridZ));
  wrap_level<TI, TO><<<grid, dim3(kTileZ, kTileY), 0, (cudaStream_t)stream>>>(f, origin, X, Y, Z, gx,
                                                                              gy, gz, level);
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
