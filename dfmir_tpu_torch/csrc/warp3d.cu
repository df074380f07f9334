// 3-D trilinear warp for Hopper (sm_90a): the forward, the flow gradient
// (dflow) and the source gradient (dsrc), three kernels and three launches.
//
// Layout NCDHW, float32.  out[b,c,z,y,x] is src[b,c] sampled trilinearly at
// (z + flow[b,0,z,y,x], y + flow[b,1,z,y,x], x + flow[b,2,z,y,x]), zero
// outside the volume.  Corner k = 4*dz + 2*dy + dx has the weight
// fz * fy * fx, with f = 1 - w for the low corner and w for the high one.
//
// What they replace.  The Pallas TPU kernels in dfmir_tpu/ops/warp_pallas.py:
//   warp3d_trilinear_fwd        <- _kernel3d            (warp3d_banded)
//   warp3d_trilinear_bwd_dflow  <- _bwd_kernel3d_dflow  (warp3d_banded_bwd_dflow)
//   warp3d_trilinear_bwd_dsrc   <- _bwd_kernel3d_dsrc   (warp3d_banded_bwd_dsrc)
// The TPU kernels DMA a (z, y) band of the source and select corners with
// weighted one-hot matmuls on the MXU (bf16 emulation, a lane-fold VMEM
// model, an `ok` predicate with a cascade of band sizes and an XLA
// fallback), because Mosaic cannot gather.  Hopper gathers and scatters
// natively, so none of that is carried over: no band, no fallback, no shape
// restriction.  The math is kept: coordinates identity + flow, clamped to
// [-2, S+1] before floor (every corner of a clamped coordinate is outside
// exactly when it was before, so the result equals the unclamped formula),
// a validity mask per corner, zero padding.
//
// What bounds them: device-memory bytes.  At the 3-D engine's shapes (the
// 160^3 data warp, the 80^3 x 3 VecInt self-warp) a launch moves tens of MB
// and does a few dozen flops a voxel.  Design: one thread per output voxel
// (b, z, y, x) over a 1-D grid of B*D*H*W, looping over channels.
// Neighbouring threads are neighbouring x, so the flow, g, output and dflow
// accesses are coalesced, and the 8 corner reads of a smooth field land on
// the same or neighbouring cache lines (left to L1/L2 via __ldg).  A faster
// design (source tiles staged in shared memory, several voxels a thread) is
// later work.
//
// Exactness.  Every product and sum is an _rn intrinsic, in a fixed order,
// so nvcc contracts nothing into FMAs; built without --use_fast_math.
// - The forward sums the corners as the plain version does
//   (dfmir_tpu_torch/ops/warp.py, the JAX package's _sample3d_trilinear):
//   out = 0; for dz, dy, dx: out = out + ((v * fz) * fy) * fx.
// - dflow forms, per corner k and summed over channels in channel order,
//     X_k = g * ((v * fz) * fy)      (d out / d fx)
//     Y_k = (g * fx) * (v * fz)      (d out / d fy)
//     Z_k = ((g * fx) * fy) * v      (d out / d fz)
//   and adds them in the order in which autograd of the plain version
//   accumulates them (its 1 - w nodes are shared by 2 or 4 corners):
//     dx = X7 - X6 + X5 - X4 + X3 - X2 + X1 - X0
//     dy = (((Y7 + Y6) - (Y5 + Y4)) + Y3 + Y2) - (Y1 + Y0)
//     dz = (((Z7 + Z6) + Z5) + Z4) - (((Z3 + Z2) + Z1) + Z0)
//   so dflow rounds as the plain version does.  A clamped coordinate has all
//   corners outside, so its dflow is 0, as the unclamped formula gives.
// - dsrc scatters ((g * fx) * fy) * fz to each corner inside the volume with
//   float32 atomicAdd into a buffer its entry zeroes (cudaMemsetAsync on
//   the launch's stream, no separate fill kernel).  It is therefore NOT
//   bitwise reproducible: the order in which the atomics land changes from
//   run to run and float addition is not associative, so two runs can differ
//   in the last bits of a sum of the few terms that hit one voxel.  Held to
//   1e-5 * max(1, max|dsrc|) of its plain version.
//
// dflow and dsrc are separate launches, as on the TPU: the data warp (source
// without a gradient) launches dflow alone and never zero-fills a dsrc.  src
// and flow may alias (VecInt's self-warp): the kernels only read them and
// write fresh buffers.

#include <cuda_runtime.h>

namespace {

// Coordinates, weights and corners of one output voxel.
struct Trilinear {
  long long off[8];   // corner k's offset within a (D, H, W) plane
  bool valid[8];      // corner k inside the volume
  float f[3][2];      // f[axis][d]: 1 - w (d = 0) and w (d = 1); axis z, y, x
};

__device__ __forceinline__ float clamp_coord(float v, int size) {
  return fminf(fmaxf(v, -2.0f), (float)size + 1.0f);
}

__device__ __forceinline__ void trilinear(const float* __restrict__ fb,
                                          long long dhw, long long p, int z,
                                          int y, int x, int D, int H, int W,
                                          Trilinear& t) {
  const float zs = clamp_coord((float)z + __ldg(fb + p), D);
  const float ys = clamp_coord((float)y + __ldg(fb + dhw + p), H);
  const float xs = clamp_coord((float)x + __ldg(fb + 2 * dhw + p), W);
  const float z0f = floorf(zs), y0f = floorf(ys), x0f = floorf(xs);
  const float wz = zs - z0f, wy = ys - y0f, wx = xs - x0f;
  t.f[0][0] = 1.0f - wz; t.f[0][1] = wz;
  t.f[1][0] = 1.0f - wy; t.f[1][1] = wy;
  t.f[2][0] = 1.0f - wx; t.f[2][1] = wx;
  const int z0 = (int)z0f, y0 = (int)y0f, x0 = (int)x0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int zi = z0 + (k >> 2), yi = y0 + ((k >> 1) & 1), xi = x0 + (k & 1);
    t.valid[k] = zi >= 0 && zi <= D - 1 && yi >= 0 && yi <= H - 1 &&
                 xi >= 0 && xi <= W - 1;
    t.off[k] = ((long long)zi * H + yi) * W + xi;
  }
}

// (b, p, z, y, x) of thread i; false past the last voxel.  The wrapper
// keeps B * max(C, 3) * D * H * W below 2^31, so 32-bit division is exact.
__device__ __forceinline__ bool voxel(long long i, int B, int D, int H, int W,
                                      long long dhw, int& b, long long& p,
                                      int& z, int& y, int& x) {
  if (i >= (long long)B * dhw) return false;
  const int n = (int)dhw, j = (int)i;
  b = j / n;
  const int q = j - b * n;
  x = q % W;
  y = (q / W) % H;
  z = q / (W * H);
  p = q;
  return true;
}

__global__ void warp3d_trilinear_fwd(const float* __restrict__ src,
                                     const float* __restrict__ flow,
                                     float* __restrict__ out,
                                     int B, int C, int D, int H, int W) {
  const long long dhw = (long long)D * H * W;
  int b, z, y, x;
  long long p;
  if (!voxel((long long)blockIdx.x * blockDim.x + threadIdx.x, B, D, H, W,
             dhw, b, p, z, y, x))
    return;
  Trilinear t;
  trilinear(flow + (long long)b * 3 * dhw, dhw, p, z, y, x, D, H, W, t);
  for (int c = 0; c < C; ++c) {
    const float* plane = src + ((long long)b * C + c) * dhw;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = t.valid[k] ? __ldg(plane + t.off[k]) : 0.0f;
      const float term = __fmul_rn(
          __fmul_rn(__fmul_rn(v, t.f[0][k >> 2]), t.f[1][(k >> 1) & 1]),
          t.f[2][k & 1]);
      acc = k == 0 ? term : __fadd_rn(acc, term);
    }
    out[((long long)b * C + c) * dhw + p] = acc;
  }
}

__global__ void warp3d_trilinear_bwd_dflow(const float* __restrict__ src,
                                           const float* __restrict__ flow,
                                           const float* __restrict__ g,
                                           float* __restrict__ dflow,
                                           int B, int C, int D, int H,
                                           int W) {
  const long long dhw = (long long)D * H * W;
  int b, z, y, x;
  long long p;
  if (!voxel((long long)blockIdx.x * blockDim.x + threadIdx.x, B, D, H, W,
             dhw, b, p, z, y, x))
    return;
  Trilinear t;
  trilinear(flow + (long long)b * 3 * dhw, dhw, p, z, y, x, D, H, W, t);
  float X[8], Y[8], Z[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) X[k] = Y[k] = Z[k] = 0.0f;
  for (int c = 0; c < C; ++c) {
    const long long plane = ((long long)b * C + c) * dhw;
    const float gc = __ldg(g + plane + p);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = t.valid[k] ? __ldg(src + plane + t.off[k]) : 0.0f;
      const float fz = t.f[0][k >> 2], fy = t.f[1][(k >> 1) & 1],
                  fx = t.f[2][k & 1];
      const float vz = __fmul_rn(v, fz);
      const float gx = __fmul_rn(gc, fx);
      X[k] = __fadd_rn(X[k], __fmul_rn(gc, __fmul_rn(vz, fy)));
      Y[k] = __fadd_rn(Y[k], __fmul_rn(gx, vz));
      Z[k] = __fadd_rn(Z[k], __fmul_rn(__fmul_rn(gx, fy), v));
    }
  }
  // the corner terms combined in the order autograd of the plain version
  // adds them (see the notes at the top)
  float dx = X[7];
#pragma unroll
  for (int k = 6; k >= 0; --k)
    dx = (k & 1) ? __fadd_rn(dx, X[k]) : __fsub_rn(dx, X[k]);
  float dy = __fsub_rn(__fadd_rn(Y[7], Y[6]), __fadd_rn(Y[5], Y[4]));
  dy = __fadd_rn(__fadd_rn(dy, Y[3]), Y[2]);
  dy = __fsub_rn(dy, __fadd_rn(Y[1], Y[0]));
  const float dz = __fsub_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(Z[7], Z[6]), Z[5]), Z[4]),
      __fadd_rn(__fadd_rn(__fadd_rn(Z[3], Z[2]), Z[1]), Z[0]));
  float* db = dflow + (long long)b * 3 * dhw;
  db[p] = dz;
  db[dhw + p] = dy;
  db[2 * dhw + p] = dx;
}

__global__ void warp3d_trilinear_bwd_dsrc(const float* __restrict__ flow,
                                          const float* __restrict__ g,
                                          float* __restrict__ dsrc,
                                          int B, int C, int D, int H, int W) {
  const long long dhw = (long long)D * H * W;
  int b, z, y, x;
  long long p;
  if (!voxel((long long)blockIdx.x * blockDim.x + threadIdx.x, B, D, H, W,
             dhw, b, p, z, y, x))
    return;
  Trilinear t;
  trilinear(flow + (long long)b * 3 * dhw, dhw, p, z, y, x, D, H, W, t);
  for (int c = 0; c < C; ++c) {
    const long long plane = ((long long)b * C + c) * dhw;
    const float gc = __ldg(g + plane + p);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!t.valid[k]) continue;
      const float w = __fmul_rn(
          __fmul_rn(__fmul_rn(gc, t.f[2][k & 1]), t.f[1][(k >> 1) & 1]),
          t.f[0][k >> 2]);
      atomicAdd(dsrc + plane + t.off[k], w);
    }
  }
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// src (B,C,D,H,W), flow (B,3,D,H,W), out (B,C,D,H,W): float32, contiguous,
// on the device of `stream`.  src and flow may alias; out must not.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int dfmir_warp3d_fwd(const float* src, const float* flow,
                                float* out, int B, int C, int D, int H, int W,
                                void* stream) {
  const long long n = (long long)B * D * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  warp3d_trilinear_fwd<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      src, flow, out, B, C, D, H, W);
  return (int)cudaGetLastError();
}

// The flow gradient of dfmir_warp3d_fwd for the output cotangent g
// (B,C,D,H,W): writes dflow (B,3,D,H,W), summed over channels.  float32,
// contiguous, on the device of `stream`.  src and flow may alias; dflow must
// not alias any input.  Returns the launch's cudaError_t.
extern "C" int dfmir_warp3d_bwd_dflow(const float* src, const float* flow,
                                      const float* g, float* dflow, int B,
                                      int C, int D, int H, int W,
                                      void* stream) {
  const long long n = (long long)B * D * H * W;
  if (n == 0) return (int)cudaSuccess;
  warp3d_trilinear_bwd_dflow<<<blocks_for(n), kThreads, 0,
                               (cudaStream_t)stream>>>(src, flow, g, dflow, B,
                                                       C, D, H, W);
  return (int)cudaGetLastError();
}

// The source gradient of dfmir_warp3d_fwd for the output cotangent g
// (B,C,D,H,W): writes dsrc (B,C,D,H,W), zeroed here on `stream` before the
// scatter.  Needs no source values.  float32, contiguous, on the device of
// `stream`; dsrc must not alias flow or g.  Returns the first cudaError_t.
extern "C" int dfmir_warp3d_bwd_dsrc(const float* flow, const float* g,
                                     float* dsrc, int B, int C, int D, int H,
                                     int W, void* stream) {
  const long long n = (long long)B * D * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  const cudaError_t err = cudaMemsetAsync(dsrc, 0, sizeof(float) * n * C,
                                          (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  warp3d_trilinear_bwd_dsrc<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(flow, g, dsrc, B, C, D,
                                                      H, W);
  return (int)cudaGetLastError();
}
