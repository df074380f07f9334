// 2-D bilinear warp, forward and backward, for Hopper (sm_90a).
//
// FORWARD
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

// BACKWARD
//
// Replaces the Pallas TPU kernel dfmir_tpu/ops/warp_pallas.py::_bwd_kernel
// (wrapper warp2d_banded_bwd, custom VJP _warp2d).  Given the cotangent g of
// the output it computes, per output pixel (b, y, x), with the forward's
// coordinates, weights (wy, wx), corner values a00..a11 (0 where a corner is
// outside) and u = 1 - w:
//   dflow_y = sum_c g * ((a10 - a00) * ux + (a11 - a01) * wx)
//   dflow_x = sum_c g * ((a01 - a00) * uy + (a11 - a10) * wy)
//   dsrc[corner] += g * weight(corner), for every corner inside the image.
// dflow is evaluated term by term, in the order in which autograd of the
// plain version (ops/warp.py) forms and adds the terms, with _rn intrinsics
// so nvcc fuses nothing into FMAs: it rounds as the plain version does
// (bit-equal in this order on the CPU).  Subtracting the corners first
// would round differently, by a few ulps of |g * a|.
// A clamped coordinate has all four corners outside, so its dflow is 0, as
// the unclamped formula gives.  The TPU kernel's band DMA, one-hot MXU
// selection matrices, bf16x3 products, `ok` predicate with its XLA fallback
// and block-granular band scatter all existed because Mosaic cannot gather
// or scatter; none is carried over.
//
// What bounds it: device-memory bytes and launch latency.  It reads flow
// (8 B/px), g (4*C B/px) and src (4*C B/px, as gathers through L1/L2), and
// writes dflow (8 B/px) and, when asked, dsrc (4*C B/px, zeroed by the
// caller); a few dozen flops a pixel.  Design: one thread per output pixel,
// as in the forward, so flow, g and dflow accesses are coalesced.  dsrc is a
// scatter: each thread adds its four weighted corners with float32
// atomicAdd (red.global.add.f32); neighbouring threads of a smooth field hit
// neighbouring addresses, so the atomics resolve in L2.
//
// dsrc is therefore NOT bitwise reproducible: the order in which the
// atomics land changes from run to run, and float addition is not
// associative, so two runs can differ in the last bits (bounded by the
// rounding of a sum of a few terms).  dflow is a per-thread sum in a fixed
// channel order and is reproducible.  A deterministic dsrc (a gather
// formulation that inverts the map per source pixel, or per-tile partial
// sums reduced in a fixed order) is later work.
//
// The dsrc scatter is skipped when dsrc is null: the full-resolution warp
// of the input images needs no source gradient.  src and flow may alias
// (VecInt's self-warp): the kernel only reads them and writes fresh buffers.
// Built without --use_fast_math.

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


__global__ void warp2d_bilinear_bwd(const float* __restrict__ src,
                                    const float* __restrict__ flow,
                                    const float* __restrict__ g,
                                    float* __restrict__ dsrc,
                                    float* __restrict__ dflow,
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

  const long long base = (long long)b * C * hw;
  const float* sb = src + base;
  const float* gb = g + base;
  // Per-corner terms, each summed over channels in channel order:
  //   cK = sum_c (g * u_x|w_x) * aK    (the terms of d out / d wy)
  //   dK = sum_c g * (aK * u_y|w_y)    (the terms of d out / d wx)
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f;
  float d00 = 0.0f, d01 = 0.0f, d10 = 0.0f, d11 = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float* plane = sb + (long long)c * hw;
    const float a00 = v00 ? __ldg(plane + o00) : 0.0f;
    const float a01 = v01 ? __ldg(plane + o01) : 0.0f;
    const float a10 = v10 ? __ldg(plane + o10) : 0.0f;
    const float a11 = v11 ? __ldg(plane + o11) : 0.0f;
    const float gc = __ldg(gb + (long long)c * hw + p);
    const float gu = __fmul_rn(gc, ux);
    const float gw = __fmul_rn(gc, wx);
    c00 = __fadd_rn(c00, __fmul_rn(gu, a00));
    c01 = __fadd_rn(c01, __fmul_rn(gw, a01));
    c10 = __fadd_rn(c10, __fmul_rn(gu, a10));
    c11 = __fadd_rn(c11, __fmul_rn(gw, a11));
    d00 = __fadd_rn(d00, __fmul_rn(gc, __fmul_rn(a00, uy)));
    d01 = __fadd_rn(d01, __fmul_rn(gc, __fmul_rn(a01, uy)));
    d10 = __fadd_rn(d10, __fmul_rn(gc, __fmul_rn(a10, wy)));
    d11 = __fadd_rn(d11, __fmul_rn(gc, __fmul_rn(a11, wy)));
    if (dsrc != nullptr) {
      float* dp = dsrc + base + (long long)c * hw;
      if (v00) atomicAdd(dp + o00, __fmul_rn(gu, uy));
      if (v01) atomicAdd(dp + o01, __fmul_rn(gw, uy));
      if (v10) atomicAdd(dp + o10, __fmul_rn(gu, wy));
      if (v11) atomicAdd(dp + o11, __fmul_rn(gw, wy));
    }
  }
  // the terms combined in the order the plain version's autograd adds them
  float* db = dflow + (long long)b * 2 * hw;
  db[p] = __fsub_rn(__fsub_rn(__fadd_rn(c11, c10), c01), c00);
  db[hw + p] = __fsub_rn(__fadd_rn(__fsub_rn(d11, d10), d01), d00);
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

// Backward of dfmir_warp2d_fwd.  src (B,C,H,W), flow (B,2,H,W), g (B,C,H,W)
// the output's cotangent; writes dflow (B,2,H,W) and, unless dsrc is null,
// adds into dsrc (B,C,H,W), which the caller zeroes first.  float32,
// contiguous, on the device of `stream`.  src and flow may alias; dsrc and
// dflow must not alias any input.  Returns the launch's cudaError_t.
extern "C" int dfmir_warp2d_bwd(const float* src, const float* flow,
                                const float* g, float* dsrc, float* dflow,
                                int B, int C, int H, int W, void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  warp2d_bilinear_bwd<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      src, flow, g, dsrc, dflow, B, C, H, W);
  return (int)cudaGetLastError();
}
