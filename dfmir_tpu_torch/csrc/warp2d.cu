// 2-D bilinear warp for Hopper (sm_90a): the single warp's forward (B1) and
// backward (B2), and VecInt's whole scaling-and-squaring chain as one
// cooperative launch each way (vecint2d_fwd, vecint2d_bwd).
//
// Layout NCHW, float32.  out[b,c,y,x] is src[b,c] sampled bilinearly at
// (y + flow[b,0,y,x], x + flow[b,1,y,x]), zero outside the image.
//
// What they replace.  The Pallas TPU kernels in dfmir_tpu/ops/warp_pallas.py:
//   warp2d_bilinear_fwd  <- _kernel      (warp2d_banded)
//   warp2d_bilinear_bwd  <- _bwd_kernel  (warp2d_banded_bwd, VJP _warp2d)
//   vecint2d_fwd         <- _kernel, called 7 times by JAX's vecint
//                           (dfmir_tpu/ops/integrate.py:82-95)
//   vecint2d_bwd         <- _bwd_kernel, called 7 times by jax.vjp of it
// The TPU kernels avoided gathers (Mosaic cannot lower them): they DMA'd a
// band of source rows and selected corners with weighted one-hot matmuls on
// the MXU, with bf16x3 emulation, a band-size limit, an `ok` predicate with
// an XLA fallback and a block-granular band scatter.  Hopper gathers and
// scatters natively, so none of that is carried over: no band, no fallback,
// no shape restriction.
//
// Per pixel (bilinear_at): coordinates clamped to [-2, S+1] before floor (the
// TPU kernel's int overflow guard; every corner of a clamped coordinate is
// outside exactly when it was before, so the result equals the unclamped
// formula), one validity flag per corner, weights w and u = 1 - w.
//
// Exactness.  Every product and sum is an _rn intrinsic in a fixed order, so
// nvcc contracts nothing into FMAs; built without --use_fast_math.
// - The forward sums ((a * u|w_y) * u|w_x) over the corners left to right,
//   the XLA path's order (dfmir_tpu/ops/warp.py:111-116): bit-equal to the
//   plain version (dfmir_tpu_torch/ops/warp.py).
// - The backward forms, per corner and summed over channels in channel order,
//     cK = (g * u|w_x) * aK        (the terms of d out / d wy)
//     dK = g * (aK * u|w_y)        (the terms of d out / d wx)
//   and adds them in the order autograd of the plain version adds them:
//     dflow_y = ((c11 + c10) - c01) - c00
//     dflow_x = ((d11 - d10) + d01) - d00
//   so dflow is bit-equal to the plain version.  Subtracting the corners first
//   would round differently, by a few ulps of |g * a|.
// - dsrc scatters g * weight(corner) to every corner inside the image with
//   float32 atomicAdd (red.global.add.f32).  It is therefore NOT bitwise
//   reproducible: the order in which the atomics land changes from run to
//   run and float addition is not associative, so two runs can differ in the
//   last bits of a sum of the few terms that hit one pixel.  Held to 1e-5 *
//   max(1, max|dsrc|) of its plain version.  A deterministic dsrc (a gather
//   per source pixel, or tile partial sums reduced in a fixed order) is
//   later work.
//
// THE SINGLE WARP (B1, B2)
//
// What bounds them: launch latency, then device-memory bytes.  Per call B1
// moves the flow (8 B/px) and the output (4*C B/px) once and reads src
// (>= 4*C B/px) as gathers; B2 reads flow, g and src and writes dflow and,
// when asked, dsrc; a few dozen flops a pixel.  At the main path's shapes
// (the (1,1,256,256) and (2,1,256,256) data warps) a launch is 2-3 us of
// device time against 20-60 us of host time in the earlier wrapper: the
// design's lever is the host path (ops/warp_cuda.py::_launch), which
// reads the raw stream without a device guard, checks its tensors with one
// cheap test, and zeroes dsrc here with cudaMemsetAsync instead of a
// separate fill kernel.
// On the device: one thread per output pixel (b, y, x) over a 1-D grid of
// B*H*W, looping over channels; neighbouring threads are neighbouring x, so
// the flow, g, output and dflow accesses are coalesced, and the four corner
// reads of a smooth field land on the same or adjacent cache lines (left to
// L1/L2 via __ldg).  dsrc is skipped when null (the data warp's source needs
// no gradient).  src and flow may alias: the kernels only read them.
//
// THE VECINT CHAIN (vecint2d_fwd, vecint2d_bwd)
//
// Scaling and squaring: v_0 = vec * 2^-n, then for k = 0..n-1
//   v_{k+1}[p] = v_k[p] + bilinear(v_k, p + v_k[p]),
// and its gradient, for G_n = dL/dv_n, for k = n-1..0
//   G_k = G_{k+1} + dflow_k(G_{k+1}) + dsrc_k(G_{k+1})   (src = flow = v_k),
//   dL/dvec = G_0 * 2^-n.
// What bounds it: launch and grid-sync latency.  VecInt's field at the main
// path's shape is (2,2,128,128) float32, 256 KB, resident in the 50 MB L2
// for the whole chain; each step is a few microseconds of dependent L2
// gathers, and as separate kernels the chain cost 15 launches forward and
// about 28 backward (B1 or B2, their adds, dsrc zero-fills), each with its
// host path.  Bytes matter only at large B.  Design: one cooperative launch
// (cudaLaunchCooperativeKernel) for the whole chain, with a grid no larger
// than the blocks that fit on the card at once (occupancy x SMs, cached per
// device; csrc/chain_launch.cuh), a grid-stride loop over the pixels and
// cooperative_groups' grid.sync() between steps.  The forward writes v_k
// into slot k of a saved stack (n, B, 2, H, W) when the input needs a
// gradient, and v_n into the output; for inference, steps and output alternate as two ping-pong
// buffers.  The backward writes each pixel's own terms (G + dflow) into a
// fresh buffer, syncs, scatters dsrc into it with atomics, syncs, and swaps
// (two syncs a step, no zero-fill and no separate adds); then scales by
// 2^-n in place.  The arithmetic per step is exactly B1's and B2's, so the
// forward chain is bit-equal to vecint(..., impl="torch").
//
// Coherence: a field written earlier in the same launch is read with __ldcg
// (L2 only), never through __ldg or const __restrict__: the read-only / L1
// path is not coherent across SMs within a launch.  Inputs the launch never
// writes (vec, g's first step, the saved stack in the backward) may use
// __ldg.  A grid larger than the co-resident limit makes the cooperative
// launch fail; the entry returns that error, and the wrapper raises.

#include <cmath>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chain_launch.cuh"

namespace cg = cooperative_groups;

namespace {

// Coordinates, weights and corners of one output pixel.
struct Bilinear {
  long long o00;               // top-left corner's offset in an (H, W) plane
  float wy, wx, uy, ux;        // weights w and u = 1 - w
  bool v00, v01, v10, v11;     // corner inside the image
};

__device__ __forceinline__ Bilinear bilinear_at(int y, int x, float fy,
                                                float fx, int H, int W) {
  float ys = (float)y + fy;
  float xs = (float)x + fx;
  ys = fminf(fmaxf(ys, -2.0f), (float)H + 1.0f);
  xs = fminf(fmaxf(xs, -2.0f), (float)W + 1.0f);
  const float y0f = floorf(ys);
  const float x0f = floorf(xs);
  Bilinear t;
  t.wy = ys - y0f;
  t.wx = xs - x0f;
  t.uy = 1.0f - t.wy;
  t.ux = 1.0f - t.wx;
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const bool vy0 = y0 >= 0 && y0 <= H - 1;
  const bool vy1 = y0 + 1 >= 0 && y0 + 1 <= H - 1;
  const bool vx0 = x0 >= 0 && x0 <= W - 1;
  const bool vx1 = x0 + 1 >= 0 && x0 + 1 <= W - 1;
  t.v00 = vy0 && vx0;
  t.v01 = vy0 && vx1;
  t.v10 = vy1 && vx0;
  t.v11 = vy1 && vx1;
  t.o00 = (long long)y0 * W + x0;
  return t;
}

// A load through the read-only path (kCoherent false: the buffer is not
// written in this launch) or from L2 alone (true: it may have been).
template <bool kCoherent>
__device__ __forceinline__ float load(const float* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}

struct Corners {
  float a00, a01, a10, a11;
};

template <bool kCoherent>
__device__ __forceinline__ Corners corners(const float* plane, long long W,
                                           const Bilinear& t) {
  Corners a;
  a.a00 = t.v00 ? load<kCoherent>(plane + t.o00) : 0.0f;
  a.a01 = t.v01 ? load<kCoherent>(plane + t.o00 + 1) : 0.0f;
  a.a10 = t.v10 ? load<kCoherent>(plane + t.o00 + W) : 0.0f;
  a.a11 = t.v11 ? load<kCoherent>(plane + t.o00 + W + 1) : 0.0f;
  return a;
}

// ((v*wy')*wx') left to right, summed left to right: the plain version's
// rounding.
__device__ __forceinline__ float blend(const Corners& a, const Bilinear& t) {
  float acc = __fmul_rn(__fmul_rn(a.a00, t.uy), t.ux);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(a.a01, t.uy), t.wx));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(a.a10, t.wy), t.ux));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(a.a11, t.wy), t.wx));
  return acc;
}

// B2's per-corner flow-gradient terms, summed over channels in channel
// order by the caller, and combined in autograd's order by dflow_y / _x.
struct DflowTerms {
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f;
  float d00 = 0.0f, d01 = 0.0f, d10 = 0.0f, d11 = 0.0f;

  __device__ __forceinline__ void add(float gc, const Corners& a,
                                      const Bilinear& t) {
    const float gu = __fmul_rn(gc, t.ux);
    const float gw = __fmul_rn(gc, t.wx);
    c00 = __fadd_rn(c00, __fmul_rn(gu, a.a00));
    c01 = __fadd_rn(c01, __fmul_rn(gw, a.a01));
    c10 = __fadd_rn(c10, __fmul_rn(gu, a.a10));
    c11 = __fadd_rn(c11, __fmul_rn(gw, a.a11));
    d00 = __fadd_rn(d00, __fmul_rn(gc, __fmul_rn(a.a00, t.uy)));
    d01 = __fadd_rn(d01, __fmul_rn(gc, __fmul_rn(a.a01, t.uy)));
    d10 = __fadd_rn(d10, __fmul_rn(gc, __fmul_rn(a.a10, t.wy)));
    d11 = __fadd_rn(d11, __fmul_rn(gc, __fmul_rn(a.a11, t.wy)));
  }
  __device__ __forceinline__ float dy() const {
    return __fsub_rn(__fsub_rn(__fadd_rn(c11, c10), c01), c00);
  }
  __device__ __forceinline__ float dx() const {
    return __fsub_rn(__fadd_rn(__fsub_rn(d11, d10), d01), d00);
  }
};

// B2's scatter of one channel's cotangent gc into a dsrc plane.
__device__ __forceinline__ void scatter(float* plane, long long W, float gc,
                                        const Bilinear& t) {
  const float gu = __fmul_rn(gc, t.ux);
  const float gw = __fmul_rn(gc, t.wx);
  if (t.v00) atomicAdd(plane + t.o00, __fmul_rn(gu, t.uy));
  if (t.v01) atomicAdd(plane + t.o00 + 1, __fmul_rn(gw, t.uy));
  if (t.v10) atomicAdd(plane + t.o00 + W, __fmul_rn(gu, t.wy));
  if (t.v11) atomicAdd(plane + t.o00 + W + 1, __fmul_rn(gw, t.wy));
}

// ------------------------------------------------------- the single warp

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
  const Bilinear t = bilinear_at(y, x, __ldg(fb + p), __ldg(fb + hw + p), H,
                                 W);
  const float* sb = src + (long long)b * C * hw;
  float* ob = out + (long long)b * C * hw;
  for (int c = 0; c < C; ++c) {
    ob[(long long)c * hw + p] =
        blend(corners<false>(sb + (long long)c * hw, W, t), t);
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
  const Bilinear t = bilinear_at(y, x, __ldg(fb + p), __ldg(fb + hw + p), H,
                                 W);
  const long long base = (long long)b * C * hw;
  DflowTerms terms;
  for (int c = 0; c < C; ++c) {
    const float gc = __ldg(g + base + (long long)c * hw + p);
    terms.add(gc, corners<false>(src + base + (long long)c * hw, W, t), t);
    if (dsrc != nullptr) scatter(dsrc + base + (long long)c * hw, W, gc, t);
  }
  float* db = dflow + (long long)b * 2 * hw;
  db[p] = terms.dy();
  db[hw + p] = terms.dx();
}

// ----------------------------------------------------------- the chain

// Where v_k lives: with a saved stack, slot k of `steps` for k < n and `out`
// for k = n; without one, `out` and the single buffer `steps` alternate so
// that v_n lands in `out`.
__device__ __forceinline__ float* field(float* steps, float* out,
                                        long long nval, int k, int n,
                                        bool save) {
  if (save) return k == n ? out : steps + (long long)k * nval;
  return ((n - k) & 1) ? steps : out;
}

__global__ void vecint2d_fwd(const float* __restrict__ vec, float* steps,
                             float* out, int B, int H, int W, int nsteps,
                             int save, float scale) {
  cg::grid_group grid = cg::this_grid();
  const long long hw = (long long)H * W;
  const long long npx = (long long)B * hw;
  const long long nval = 2 * npx;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  float* v0 = field(steps, out, nval, 0, nsteps, save);
  for (long long j = first; j < nval; j += stride) {
    __stcg(v0 + j, __fmul_rn(__ldg(vec + j), scale));
  }
  for (int k = 0; k < nsteps; ++k) {
    grid.sync();
    const float* v = field(steps, out, nval, k, nsteps, save);
    float* next = field(steps, out, nval, k + 1, nsteps, save);
    for (long long i = first; i < npx; i += stride) {
      const int b = (int)(i / hw);
      const long long p = i - b * hw;
      const int y = (int)(p / W);
      const int x = (int)(p - (long long)y * W);
      const float* vb = v + (long long)b * 2 * hw;
      const float fy = __ldcg(vb + p);
      const float fx = __ldcg(vb + hw + p);
      const Bilinear t = bilinear_at(y, x, fy, fx, H, W);
      float* nb = next + (long long)b * 2 * hw;
      __stcg(nb + p, __fadd_rn(fy, blend(corners<true>(vb, W, t), t)));
      __stcg(nb + hw + p,
             __fadd_rn(fx, blend(corners<true>(vb + hw, W, t), t)));
    }
  }
}

// G_{k+1} is `gin`; G_k is built in `acc`: the last step's acc is dvec, and
// dvec and the single buffer `scratch` alternate before it.
__global__ void vecint2d_bwd(const float* __restrict__ steps,
                             const float* __restrict__ g, float* scratch,
                             float* dvec, int B, int H, int W, int nsteps,
                             float scale) {
  cg::grid_group grid = cg::this_grid();
  const long long hw = (long long)H * W;
  const long long npx = (long long)B * hw;
  const long long nval = 2 * npx;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  const float* gin = g;
  for (int k = nsteps - 1; k >= 0; --k) {
    const float* v = steps + (long long)k * nval;
    float* acc = (k & 1) ? scratch : dvec;
    // each pixel's own terms: acc = G + dflow
    for (long long i = first; i < npx; i += stride) {
      const int b = (int)(i / hw);
      const long long p = i - b * hw;
      const int y = (int)(p / W);
      const int x = (int)(p - (long long)y * W);
      const float* vb = v + (long long)b * 2 * hw;
      const Bilinear t = bilinear_at(y, x, __ldg(vb + p), __ldg(vb + hw + p),
                                     H, W);
      const float* gb = gin + (long long)b * 2 * hw;
      const float g0 = __ldcg(gb + p);
      const float g1 = __ldcg(gb + hw + p);
      DflowTerms terms;
      terms.add(g0, corners<false>(vb, W, t), t);
      terms.add(g1, corners<false>(vb + hw, W, t), t);
      float* ab = acc + (long long)b * 2 * hw;
      __stcg(ab + p, __fadd_rn(g0, terms.dy()));
      __stcg(ab + hw + p, __fadd_rn(g1, terms.dx()));
    }
    grid.sync();
    // then every pixel's dsrc scattered into the others
    for (long long i = first; i < npx; i += stride) {
      const int b = (int)(i / hw);
      const long long p = i - b * hw;
      const int y = (int)(p / W);
      const int x = (int)(p - (long long)y * W);
      const float* vb = v + (long long)b * 2 * hw;
      const Bilinear t = bilinear_at(y, x, __ldg(vb + p), __ldg(vb + hw + p),
                                     H, W);
      const float* gb = gin + (long long)b * 2 * hw;
      float* ab = acc + (long long)b * 2 * hw;
      scatter(ab, W, __ldcg(gb + p), t);
      scatter(ab + hw, W, __ldcg(gb + hw + p), t);
    }
    grid.sync();
    gin = acc;
  }
  for (long long j = first; j < nval; j += stride) {
    __stcg(dvec + j, __fmul_rn(__ldcg(gin + j), scale));
  }
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

int fwd_resident[kMaxDevices];
int bwd_resident[kMaxDevices];

}  // namespace

// src (B,C,H,W), flow (B,2,H,W), out (B,C,H,W): float32, contiguous, on the
// device of `stream`.  src and flow may alias; out must not.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int dfmir_warp2d_fwd(const float* src, const float* flow,
                                float* out, int B, int C, int H, int W,
                                void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  warp2d_bilinear_fwd<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      src, flow, out, B, C, H, W);
  return (int)cudaGetLastError();
}

// Backward of dfmir_warp2d_fwd.  src (B,C,H,W), flow (B,2,H,W), g (B,C,H,W)
// the output's cotangent; writes dflow (B,2,H,W) and, unless dsrc is null,
// dsrc (B,C,H,W), zeroed here on `stream` before the scatter.  float32,
// contiguous, on the device of `stream`.  src and flow may alias; dsrc and
// dflow must not alias any input.  Returns the first cudaError_t.
extern "C" int dfmir_warp2d_bwd(const float* src, const float* flow,
                                const float* g, float* dsrc, float* dflow,
                                int B, int C, int H, int W, void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0) return (int)cudaSuccess;
  if (dsrc != nullptr) {
    const cudaError_t err = cudaMemsetAsync(
        dsrc, 0, sizeof(float) * n * C, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  warp2d_bilinear_bwd<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      src, flow, g, dsrc, dflow, B, C, H, W);
  return (int)cudaGetLastError();
}

// VecInt forward: vec (B,2,H,W) -> out (B,2,H,W), nsteps squarings.  With
// `save`, `steps` is (nsteps,B,2,H,W) and receives v_0..v_{n-1}; without, it
// is one (B,2,H,W) buffer (unused when nsteps is 0).  `blocks` 0 sizes the
// grid to the co-resident limit.  float32, contiguous, on the device of
// `stream`; no buffer aliases another.  Returns the launch's cudaError_t.
extern "C" int dfmir_vecint2d_fwd(const float* vec, float* steps, float* out,
                                  int B, int H, int W, int nsteps, int save,
                                  int blocks, void* stream) {
  const long long npx = (long long)B * H * W;
  if (npx == 0) return (int)cudaSuccess;
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&vec, &steps, &out, &B, &H, &W, &nsteps, &save, &scale};
  return (int)launch_chain((const void*)vecint2d_fwd, fwd_resident, npx,
                           blocks, args, stream);
}

// VecInt backward: steps (nsteps,B,2,H,W) the forward's saved v_0..v_{n-1},
// g (B,2,H,W) the cotangent of v_n; writes dvec (B,2,H,W).  `scratch` is one
// (B,2,H,W) buffer (unused when nsteps < 2).  `blocks` as in the forward.
// float32, contiguous, on the device of `stream`; dvec and scratch alias
// nothing.  Returns the launch's cudaError_t.
extern "C" int dfmir_vecint2d_bwd(const float* steps, const float* g,
                                  float* scratch, float* dvec, int B, int H,
                                  int W, int nsteps, int blocks,
                                  void* stream) {
  const long long npx = (long long)B * H * W;
  if (npx == 0) return (int)cudaSuccess;
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&steps, &g, &scratch, &dvec, &B, &H, &W, &nsteps, &scale};
  return (int)launch_chain((const void*)vecint2d_bwd, bwd_resident, npx,
                           blocks, args, stream);
}
