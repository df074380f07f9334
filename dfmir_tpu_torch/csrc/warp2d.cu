// 2-D bilinear warp forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dfmir_tpu/ops/warp_pallas.py::_kernel
// (wrapper warp2d_banded): out[b,c,y,x] is src[b,c] sampled bilinearly at
// (y + flow[b,0,y,x], x + flow[b,1,y,x]), zero outside the image.  Layout
// NCHW, float32.
//
// The TPU kernel avoided gathers (Mosaic cannot lower them): it DMA'd a band
// of source rows and selected corners with a weighted one-hot matmul on the
// MXU, with bf16x3 emulation, a band-size limit and an XLA fallback.  Hopper
// gathers natively, so none of that is carried over: no band, no fallback,
// no shape restriction.
//
// What bounds it: device-memory bytes and launch latency.  Per call it moves
// the flow (8 B/px) and the output (4*C B/px) once, and reads src (>= 4*C
// B/px) through L2 as gathers; the arithmetic is a few dozen flops a pixel.
// Design: one thread per output pixel (b, y, x) over a 1-D grid of B*H*W.
// Neighbouring threads are neighbouring x, so the flow reads and the output
// writes are coalesced, and the four corner reads of a smooth field land on
// the same or adjacent cache lines, left to L1/L2 via __ldg.  A faster design
// (a block per row tile, src rows staged in shared memory, several pixels
// per thread) is later work.
//
// Coordinates are clamped to [-2, S+1] before floor (the TPU kernel's int
// overflow guard); every corner of a clamped coordinate is outside the image
// exactly when it was before, so the result equals the unclamped formula.
// The corners are summed in the XLA path's order
// (dfmir_tpu/ops/warp.py:111-116).  Built without --use_fast_math.

#include <cuda_runtime.h>

namespace {

__global__ void warp2d_bilinear_fwd(const float* __restrict__ src,
                                    const float* __restrict__ flow,
                                    float* __restrict__ out,
                                    int B, int C, int H, int W) {
  const long long hw = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * hw) return;
  const int b = (int)(i / hw);
  const long long p = i - b * hw;
  const int y = (int)(p / W);
  const int x = (int)(p - (long long)y * W);

  const float* fb = flow + (long long)b * 2 * hw;
  float ys = (float)y + __ldg(fb + p);
  float xs = (float)x + __ldg(fb + hw + p);
  ys = fminf(fmaxf(ys, -2.0f), (float)H + 1.0f);
  xs = fminf(fmaxf(xs, -2.0f), (float)W + 1.0f);
  const float y0f = floorf(ys);
  const float x0f = floorf(xs);
  const float wy = ys - y0f;
  const float wx = xs - x0f;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const int y1 = y0 + 1;
  const int x1 = x0 + 1;

  const bool vy0 = y0 >= 0 && y0 <= H - 1;
  const bool vy1 = y1 >= 0 && y1 <= H - 1;
  const bool vx0 = x0 >= 0 && x0 <= W - 1;
  const bool vx1 = x1 >= 0 && x1 <= W - 1;
  const bool v00 = vy0 && vx0, v01 = vy0 && vx1;
  const bool v10 = vy1 && vx0, v11 = vy1 && vx1;
  const long long o00 = (long long)y0 * W + x0;
  const long long o01 = o00 + 1;
  const long long o10 = o00 + W;
  const long long o11 = o10 + 1;

  const float uy = 1.0f - wy;
  const float ux = 1.0f - wx;

  const float* sb = src + (long long)b * C * hw;
  float* ob = out + (long long)b * C * hw;
  for (int c = 0; c < C; ++c) {
    const float* plane = sb + (long long)c * hw;
    const float a00 = v00 ? __ldg(plane + o00) : 0.0f;
    const float a01 = v01 ? __ldg(plane + o01) : 0.0f;
    const float a10 = v10 ? __ldg(plane + o10) : 0.0f;
    const float a11 = v11 ? __ldg(plane + o11) : 0.0f;
    // ((v*wy')*wx') left to right, summed left to right; the _rn intrinsics
    // keep nvcc from contracting into FMAs, so the rounding is the plain
    // version's.
    float acc = __fmul_rn(__fmul_rn(a00, uy), ux);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(a01, uy), wx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(a10, wy), ux));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(a11, wy), wx));
    ob[(long long)c * hw + p] = acc;
  }
}

}  // namespace

// src (B,C,H,W), flow (B,2,H,W), out (B,C,H,W): float32, contiguous, on the
// device of `stream`.  src and flow may alias; out must not.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int dfmir_warp2d_fwd(const float* src, const float* flow,
                                float* out, int B, int C, int H, int W,
                                void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  warp2d_bilinear_fwd<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      src, flow, out, B, C, H, W);
  return (int)cudaGetLastError();
}
