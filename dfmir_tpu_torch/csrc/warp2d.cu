// 2-D bilinear warp for Hopper (sm_90a): the single warp's forward (B1) and
// backward (B2), and VecInt's whole scaling-and-squaring chain as one
// launch each way (vecint2d_fwd, cooperative; vecint2d_bwd, a
// thread-block cluster a batch item).
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
// - B2's dsrc scatters g * weight(corner) to every corner inside the image
//   with float32 atomicAdd (red.global.add.f32).  It is therefore NOT
//   bitwise reproducible: the order in which the atomics land changes from
//   run to run and float addition is not associative, so two runs can
//   differ in the last bits of a sum of the few terms that hit one pixel.
//   Held to 1e-5 * max(1, max|dsrc|) of its plain version.
// - vecint2d_bwd's dsrc forms the same terms and adds them as integers in
//   an int64 fixed point (csrc/fixed_point.cuh), so it is the same bits on
//   every run, equal to ops/integrate.py's vecint2d_bwd_fixed_plain, and
//   within 1e-5 * max(1, max|dvec|) of autograd of the plain loop.  Its
//   scale is per batch item (e_b from max|G| over item b's two channels,
//   at most H*W terms a sum), where the 3-D chain's is the whole tensor's:
//   a whole-batch max would need every item's blocks to meet, and per item
//   each item's gradient does not depend on the others'.
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
// What bounds it: launch and synchronisation latency.  VecInt's field at
// the main path's shape is (2,2,128,128) float32, 256 KB, resident in the
// 50 MB L2 for the whole chain; each step is a few microseconds of
// dependent L2 gathers, and as separate kernels the chain cost 15 launches
// forward and about 28 backward (B1 or B2, their adds, dsrc zero-fills),
// each with its host path.  Bytes matter only at large B.
// - The forward: one cooperative launch (cudaLaunchCooperativeKernel) for
//   the whole chain, with a grid no larger than the blocks that fit on the
//   card at once (occupancy x SMs, cached per device;
//   csrc/chain_launch.cuh), a grid-stride loop over the pixels and
//   cooperative_groups' grid.sync() between steps.  It writes v_k into
//   slot k of a saved stack (n, B, 2, H, W) when the input needs a
//   gradient, and v_n into the output; for inference, steps and output
//   alternate as two ping-pong buffers.  The arithmetic per step is
//   exactly B1's, so it is bit-equal to vecint(..., impl="torch").
// - The backward: no batch item reads another's data, so each item is one
//   thread-block cluster (16 blocks of 512 threads; cudaLaunchKernelEx with
//   a cluster dimension), and every barrier is a cluster barrier, where
//   grid.sync() over the whole grid cost 1.1-1.8 us and a cluster barrier
//   0.6-0.7 us (csrc/yardsticks/sync.cu on an H100; chip_smoke.py).  The
//   launch needs no cooperative grid: clusters run in any number of waves.
//   A block owns a run of its item's pixels, each pixel read and written
//   by the thread that owns it, so G never crosses blocks: G and the own
//   terms stay in the thread's registers when a thread owns at most
//   kRegPixels pixels (the main path's 128^2 in 16 blocks of 512), else in
//   dvec (read through L2).
//   Per step, two phases, a cluster barrier after each: (1) each pixel's
//   own terms G + dflow (B2's terms, in autograd's order) into dvec, and
//   its dsrc terms added as int64s into the sums of the pixels they land
//   on: a pixel the block owns in its shared memory (two 32-bit halves
//   with a carry: a 64-bit shared atomic add is a compare-and-swap loop),
//   any other in the item's sums in global memory (a native 64-bit atomic
//   add), so most terms (those that stay in the block's rows) never
//   leave the SM; (2) G_k = own + (both
//   sums) * 2^-e_b at the block's pixels, the sums zeroed for the next
//   step, and max|G_k| over the cluster (each block's max in its shared
//   memory, read by the others through distributed shared memory) for the
//   next step's e_b.  The last pass writes G_0 * 2^-n.  No float atomics
//   and no grid.sync().
//
// Coherence: a field written earlier in the same launch by another SM is
// read with __ldcg (L2 only), never through __ldg or const __restrict__:
// the read-only / L1 path is not coherent across SMs within a launch.  The
// backward's sums are such a field; the cluster barrier (arrive.release /
// wait.acquire) orders their atomics before the reads.  Inputs the launch
// never writes (vec, g, the saved stack in the backward) may use __ldg.  A
// grid larger than the co-resident limit makes the forward's cooperative
// launch fail, and a cluster size the card refuses the backward's; the
// entry returns that error, and the wrapper raises.

#include <cmath>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chain_launch.cuh"
#include "fixed_point.cuh"

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

// vecint2d_bwd's dsrc terms of one channel's cotangent gc, formed as
// scatter forms them, each handed to add(corner's offset, the term in the
// fixed point f) as an integer.
template <typename Add>
__device__ __forceinline__ void scatter_fixed(float gc, const Bilinear& t,
                                              int W, const Fixed& f,
                                              Add add) {
  const float gu = __fmul_rn(gc, t.ux);
  const float gw = __fmul_rn(gc, t.wx);
  const int o = (int)t.o00;
  auto fixed = [&](float term) {
    return __float2ll_rn(__fmul_rn(term, f.scale));
  };
  if (t.v00) add(o, fixed(__fmul_rn(gu, t.uy)));
  if (t.v01) add(o + 1, fixed(__fmul_rn(gw, t.uy)));
  if (t.v10) add(o + W, fixed(__fmul_rn(gu, t.wy)));
  if (t.v11) add(o + W + 1, fixed(__fmul_rn(gw, t.wy)));
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

// The backward chain's block: kClusterThreads threads, a cluster of
// kClusterBlocks blocks a batch item unless the entry is given another
// size (at most 16).
constexpr int kClusterThreads = 512;
constexpr int kClusterBlocks = 16;
// A block keeps the sums of its own pixels in shared memory when it owns
// at most kLocalPixels of them (1,024 at 128^2 in 16 blocks).
constexpr int kLocalPixels = 2048;

// The max of m over this block's threads, then over the cluster's blocks,
// in every thread: each block's max in its shared `mine`, a cluster
// barrier, and each warp reading the blocks' values through distributed
// shared memory.  Every thread of the cluster calls it.
__device__ __forceinline__ unsigned cluster_max(cg::cluster_group& cluster,
                                                unsigned m, unsigned* mine,
                                                unsigned* sh) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kClusterThreads / 32; ++w) m = max(m, sh[w]);
    *mine = m;
  }
  cluster.sync();
  const unsigned r = threadIdx.x & 31;
  m = r < cluster.num_blocks() ? *cluster.map_shared_rank(mine, r) : 0u;
  return __reduce_max_sync(0xffffffffu, m);
}

// The backward chain, one cluster a batch item b (the cluster's blocks
// split its pixels; block r takes pixels [r, r + 1) * H*W / size).  G
// lives in registers (kRegs) or dvec, each pixel read and written by the
// thread that owns it; the dsrc sums of a block's own pixels in its shared
// memory (when it owns at most kLocalPixels) and all others in `sums`,
// (B, 2, H, W) int64, added to by every block of the cluster.  Per step
// k = n-1..0:
//   1. each pixel's own terms G + dflow (registers or dvec), and its dsrc
//      terms into
//      the sums of the corners it samples, in the item's fixed point (from
//      max|G_{k+1}| over the item);
//   2. after a cluster barrier, G_k = own + sum * 2^-e at each pixel, its
//      sums zeroed, and max|G_k| over the item (a second barrier).
// The last pass writes G_0 * 2^-n.  kRegs: every block owns at most
// kRegPixels pixels a thread, and G and the own terms stay in its threads'
// registers instead of dvec.  Capped at 64 registers, so that two blocks
// fit a SM.
constexpr int kRegPixels = 2;

template <bool kRegs>
__global__ void __launch_bounds__(kClusterThreads, 2)
    vecint2d_bwd(const float* __restrict__ steps, const float* __restrict__ g,
                 unsigned long long* __restrict__ sums,
                 float* __restrict__ dvec, int B, int H, int W, int nsteps,
                 float scale) {
  __shared__ unsigned sh[kClusterThreads / 32];
  __shared__ unsigned mine;
  __shared__ unsigned local_lo[2][kLocalPixels], local_hi[2][kLocalPixels];
  cg::cluster_group cluster = cg::this_cluster();
  const int size = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / size;
  const int hw = H * W;
  const int lo = (int)((long long)hw * rank / size);
  const int hi = (int)((long long)hw * (rank + 1) / size);
  const int first = lo + threadIdx.x;
  const float* gb = g + b * 2 * hw;
  float* db = dvec + b * 2 * hw;
  unsigned long long* sb = sums + b * 2 * hw;
  float G[kRegPixels][2], own[kRegPixels][2];   // kRegs only

  // fn(slot, p) at each pixel p of this thread
  auto for_pixels = [&](auto&& fn) {
    if constexpr (kRegs) {
#pragma unroll
      for (int i = 0; i < kRegPixels; ++i) {
        const int p = first + i * kClusterThreads;
        if (p < hi) fn(i, p);
      }
    } else {
      for (int p = first; p < hi; p += kClusterThreads) fn(0, p);
    }
  };

  // a term for this block's own pixels goes into its shared sums (two
  // 32-bit halves, lo handing its carry to hi: a 64-bit shared atomic is
  // a compare-and-swap loop), any other into the item's sums in global
  // memory; both are exact integer sums, added at the pixel's owner
  const bool local = hi - lo <= kLocalPixels;
  auto add = [&](int c, int o, long long v) {
    if (local && o >= lo && o < hi) {
      const unsigned l = (unsigned)v;
      const unsigned old = atomicAdd(&local_lo[c][o - lo], l);
      atomicAdd(&local_hi[c][o - lo],
                (unsigned)(v >> 32) + (old + l < old ? 1u : 0u));
    } else {
      atomicAdd(sb + c * hw + o, (unsigned long long)v);
    }
  };
  unsigned m = 0;
  for_pixels([&](int i, int p) {
    sb[p] = 0;
    sb[hw + p] = 0;
    if (local) {
      local_lo[0][p - lo] = local_lo[1][p - lo] = 0;
      local_hi[0][p - lo] = local_hi[1][p - lo] = 0;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float gc = __ldg(gb + c * hw + p);
      if constexpr (kRegs) G[i][c] = gc;
      m = max(m, abs_bits(gc));
    }
  });
  m = cluster_max(cluster, m, &mine, sh);
  if (nsteps == 0) {
    for_pixels([&](int, int p) {
      db[p] = __fmul_rn(__ldg(gb + p), scale);
      db[hw + p] = __fmul_rn(__ldg(gb + hw + p), scale);
    });
  }
  for (int k = nsteps - 1; k >= 0; --k) {
    const Fixed f = fixed_of(m, hw);
    const float* vb = steps + ((long long)k * B + b) * 2 * hw;
    for_pixels([&](int i, int p) {
      const int y = p / W;
      const int x = p - y * W;
      const Bilinear t = bilinear_at(y, x, __ldg(vb + p), __ldg(vb + hw + p),
                                     H, W);
      const Corners a0 = corners<false>(vb, W, t);
      const Corners a1 = corners<false>(vb + hw, W, t);
      float g0, g1;
      if constexpr (kRegs) {
        g0 = G[i][0];
        g1 = G[i][1];
      } else {
        const bool in_g = k == nsteps - 1;
        g0 = in_g ? __ldg(gb + p) : __ldcg(db + p);
        g1 = in_g ? __ldg(gb + hw + p) : __ldcg(db + hw + p);
      }
      DflowTerms terms;
      terms.add(g0, a0, t);
      terms.add(g1, a1, t);
      const float o0 = __fadd_rn(g0, terms.dy());
      const float o1 = __fadd_rn(g1, terms.dx());
      if constexpr (kRegs) {
        own[i][0] = o0;
        own[i][1] = o1;
      } else {
        __stcg(db + p, o0);
        __stcg(db + hw + p, o1);
      }
      scatter_fixed(g0, t, W, f, [&](int o, long long v) { add(0, o, v); });
      scatter_fixed(g1, t, W, f, [&](int o, long long v) { add(1, o, v); });
    });
    cluster.sync();
    m = 0;
    for_pixels([&](int i, int p) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int o = c * hw + p;
        unsigned long long sum = __ldcg(sb + o);
        if (local) {
          sum += (unsigned long long)local_hi[c][p - lo] << 32 |
                 local_lo[c][p - lo];
        }
        const float dsrc =
            f.finite ? __fmul_rn(__ll2float_rn((long long)sum), f.inv)
                     : __int_as_float(0x7fffffff);
        float Gk;
        if constexpr (kRegs) {
          Gk = __fadd_rn(own[i][c], dsrc);
        } else {
          Gk = __fadd_rn(__ldcg(db + o), dsrc);
        }
        if (k == 0) {
          db[o] = __fmul_rn(Gk, scale);
        } else {
          if constexpr (kRegs) {
            G[i][c] = Gk;
          } else {
            __stcg(db + o, Gk);
          }
          __stcg(sb + o, 0ull);
          if (local) local_lo[c][p - lo] = local_hi[c][p - lo] = 0;
          m = max(m, abs_bits(Gk));
        }
      }
    });
    if (k > 0) m = cluster_max(cluster, m, &mine, sh);
  }
  // No block may leave while another reads its `mine`: the last reads
  // come before step 0's barrier, or, without steps, here.
  if (nsteps == 0) cluster.sync();
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

int fwd_resident[kMaxDevices];

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
// g (B,2,H,W) the cotangent of v_n; writes dvec (B,2,H,W), bitwise the
// same on every run.  `sums` is (B,2,H,W) int64 scratch, zeroed by the
// launch.  `cluster` is the blocks of a batch item's cluster (0: 16); a
// size the card refuses (above 16) fails the launch.  float32,
// contiguous, on the device of `stream`; dvec and sums alias nothing.
// Returns the launch's cudaError_t.
extern "C" int dfmir_vecint2d_bwd(const float* steps, const float* g,
                                  unsigned long long* sums, float* dvec,
                                  int B, int H, int W, int nsteps,
                                  int cluster, void* stream) {
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  if (cluster == 0) cluster = kClusterBlocks;
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&steps, &g, &sums, &dvec, &B, &H, &W, &nsteps, &scale};
  // G in registers when no block owns more than kRegPixels pixels a thread
  const long long per = ((long long)H * W + cluster - 1) / cluster;
  const void* kernel = per <= (long long)kRegPixels * kClusterThreads
                           ? (const void*)vecint2d_bwd<true>
                           : (const void*)vecint2d_bwd<false>;
  return (int)launch_clusters(kernel, kClusterThreads, B, cluster, args,
                              stream);
}

// The clusters of *cluster blocks of vecint2d_bwd (0: set to the entry's
// own size) that the card holds at once, in *active.  Returns the query's
// cudaError_t.
extern "C" int dfmir_vecint2d_bwd_clusters(int* cluster, int* active) {
  if (*cluster == 0) *cluster = kClusterBlocks;
  return (int)active_clusters((const void*)vecint2d_bwd<true>,
                              kClusterThreads, *cluster, active);
}
