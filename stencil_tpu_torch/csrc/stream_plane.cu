// One level of a traced user kernel over shell-carrying blocks, for Hopper
// (sm_90a), bound to Python through ctypes (stencil_tpu_torch/kernels/
// build.py, stencil_tpu_torch/ops/stream.py).
//
// A kernel template: the line `// @STP_GENERATED@` below is replaced by the
// body that stencil_tpu_torch/ops/stream_trace.py emits for one user kernel
// (STP_NF, the field count, and stp_body, the kernel's arithmetic), and the
// result is built by nvcc into a library of its own.
//
// stp_stream_plane_level replaces stencil_tpu/ops/stream.py:279
//   stream_plane_pass: one level of a user kernel over n shell-carrying
//   (X, Y, Z) blocks per field in ONE launch (the leading block dimension
//   stands in for shard_map).  Shell widths lo/hi per axis, any read radius
//   r >= 1 up to them; the shell passes through unchanged.  The TPU kernel
//   streams x-planes through a 2r-deep VMEM ring; here each thread owns one
//   (y, z) column and walks the planes of all blocks.
//
// Bound on an H100 SXM: bytes, 8 B per cell and field and level.  Interior
// cells read their neighbours straight from global memory (re-reads left to
// L1/L2): the shell is at least r wide, so no read leaves the block.  A
// shared-memory plane ring is later work.
//
// Bitwise contract: stp_body uses __fadd_rn/__fmul_rn/... (no contraction);
// the global coordinates are (origin + index - lo) mod global size, as
// _yz_coord_planes computes them in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

// @STP_GENERATED@

namespace {

constexpr int kTileZ = 32;
constexpr int kTileY = 8;
constexpr int kMaxGridZ = 65535;

struct Fields {
  const float* in[STP_NF];
  float* out[STP_NF];
};

struct Geometry {
  int n, X, Y, Z;
  int lox, loy, loz, hix, hiy, hiz;
  int gx, gy, gz;
};

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// grid: (ceil(Z/32), ceil(Y/8), min(n*X, 65535)); p = block*X + x strides by
// gridDim.z.  origins: (n, 3) int32, each block's interior start.
__global__ void plane_level(Fields f, const int* __restrict__ origins, Geometry g) {
  const int z = blockIdx.x * kTileZ + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (z >= g.Z || y >= g.Y) return;
  const int64_t plane = (int64_t)g.Y * g.Z;
  const bool ring = y < g.loy || y >= g.Y - g.hiy || z < g.loz || z >= g.Z - g.hiz;
  const int64_t total = (int64_t)g.n * g.X;
  for (int64_t p = blockIdx.z; p < total; p += gridDim.z) {
    const int64_t b = p / g.X;
    const int x = (int)(p - b * g.X);
    const int64_t idx = p * plane + (int64_t)y * g.Z + z;
    if (ring || x < g.lox || x >= g.X - g.hix) {
#pragma unroll
      for (int q = 0; q < STP_NF; ++q) f.out[q][idx] = f.in[q][idx];  // shell passes through
      continue;
    }
    const int xg = pmod(origins[3 * b] + x - g.lox, g.gx);
    const int yg = pmod(origins[3 * b + 1] + y - g.loy, g.gy);
    const int zg = pmod(origins[3 * b + 2] + z - g.loz, g.gz);
    auto ld = [&](int q, int dx, int dy, int dz) -> float {
      return f.in[q][idx + dx * plane + (int64_t)dy * g.Z + dz];
    };
    float out[STP_NF];
    stp_body(ld, 1, xg, yg, zg, out);
#pragma unroll
    for (int q = 0; q < STP_NF; ++q) f.out[q][idx] = out[q];
  }
}

}  // namespace

extern "C" {

// in/out: host arrays of STP_NF device pointers, each n (X, Y, Z) float32
// blocks; origins: (n, 3) int32 on the device.  Returns a CUDA error code, or
// -1 for arguments the kernel does not take.
int stp_stream_plane_level(void* const* in, void* const* out, const int* origins, int n, int X,
                           int Y, int Z, int lox, int loy, int loz, int hix, int hiy, int hiz,
                           int gx, int gy, int gz, void* stream) {
  if (n < 1 || lox + hix >= X || loy + hiy >= Y || loz + hiz >= Z || gx < 1 || gy < 1 ||
      gz < 1)
    return -1;
  Fields f;
  for (int q = 0; q < STP_NF; ++q) {
    f.in[q] = static_cast<const float*>(in[q]);
    f.out[q] = static_cast<float*>(out[q]);
  }
  const Geometry g{n, X, Y, Z, lox, loy, loz, hix, hiy, hiz, gx, gy, gz};
  const int64_t planes = (int64_t)n * X;
  dim3 grid((Z + kTileZ - 1) / kTileZ, (Y + kTileY - 1) / kTileY,
            (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
  plane_level<<<grid, dim3(kTileZ, kTileY), 0, (cudaStream_t)stream>>>(f, origins, g);
  return (int)cudaGetLastError();
}

const char* stp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
