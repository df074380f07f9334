// 2-D bilinear warp for Hopper (sm_90a): the single warp's forward (B1) and
// backward (B2), and VecInt's whole scaling-and-squaring chain as one
// launch each way (vecint2d_fwd, vecint2d_bwd: a thread-block cluster a
// batch item each).
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
// - Every source gradient (B2's dsrc, vecint2d_bwd's) forms the terms
//   (g * u|w_x) * u|w_y of each corner inside the image and adds them as
//   integers in an int64 fixed point (csrc/fixed_point.cuh), so it is the
//   same bits on every run: B2's equal to ops/warp.py's
//   warp2d_dsrc_fixed_plain, vecint2d_bwd's to ops/integrate.py's
//   vecint2d_bwd_fixed_plain, each within 1e-5 * max(1, max|dsrc|) of
//   autograd.  The scale is per batch item (e_b from max|g| over item b's
//   channels, at most H*W terms a sum), where the 3-D kernels' is the whole
//   tensor's: a whole-batch max would need every item's blocks to meet, and
//   per item each item's gradient does not depend on the others'.  No
//   float atomics remain in this file.
//
// THE SINGLE WARP (B1, B2)
//
// What bounds them: launch latency, then device-memory bytes.  Per call B1
// moves the flow (8 B/px) and the output (4*C B/px) once and reads src
// (>= 4*C B/px) as gathers; B2 reads flow, g and src and writes dflow and,
// when asked, dsrc; a few dozen flops a pixel.  At the main path's shapes
// (the (1,1,256,256) and (2,1,256,256) data warps) a launch is 2-5 us of
// device time against 20-60 us of host time in the earlier wrapper: the
// design's lever is the host path (ops/warp_cuda.py::_launch), which
// reads the raw stream without a device guard and checks its tensors with
// one cheap test.
// - B1 and B2 without a source gradient (the data warp): one thread per
//   output pixel (b, y, x) over a 1-D grid of B*H*W, looping over
//   channels; neighbouring threads are neighbouring x, so the flow, g,
//   output and dflow accesses are coalesced, and the four corner reads of
//   a smooth field land on the same or adjacent cache lines (left to L1/L2
//   via __ldg).  src and flow may alias: the kernels only read them.
// - B2 with a source gradient: the fixed point needs max|g| over the item
//   before the first term is rounded, and the main path's case, the
//   `registered` warp at (1,1,256,256), is one item, so the work has to
//   span the card: one cooperative launch (csrc/chain_launch.cuh,
//   launch_chain), `per_item` blocks an item, at most the blocks the card
//   holds at once, in three passes: (1) each block zeroes its pixels' int64
//   sums and writes its max|g| over them; grid.sync(); (2) e_b from the
//   item's per_item maxes, each pixel's dflow, and its dsrc terms added
//   into the sums of the pixels they land on with native 64-bit atomics in
//   L2; grid.sync(); (3) each pixel's sums * 2^-e_b.  No memset and no
//   zero-fill kernel; the scratch (sums and maxes) comes from the wrapper.
//   Its cost over the float scatter it replaces: two grid syncs (1.1-1.3
//   us each) and the two passes around them.  One cluster a batch item
//   (the chains' design) ran 1.7-2.5x slower at B = 1, on 16 of the
//   card's 132 SMs (PERF.md, Findings).
// - B1 on a row slab (dfmir_warp2d_fwd_slab): the output and the flow are
//   rows [y0, y0 + H) of an image of Hs rows split along H over ranks, and
//   src is that whole image (gathered).  Row y samples the source at row
//   (y + y0) + flow_y: the global row is formed in int before its
//   conversion to float, as B3 forms z + z0 (csrc/warp3d.cu), so a slab's
//   rows are the whole image's rows bit for bit.  The whole image keeps its
//   own instance of the kernel (kSlab false) and its entry.
// - B2 on a row slab (dfmir_warp2d_bwd_slab): the same rows of flow and g,
//   src the whole image.  dflow is the slab's rows, formed as above, so
//   the whole image's B2 rows bit for bit.  The source gradient is the
//   slab's terms summed over the whole source, left as int64s: B2's fixed
//   point is per batch item, and two ranks summing in their own units
//   could not add their sums, so the scale comes from the caller (each
//   item's max|g| over the whole image, all-reduced over the ranks: one
//   uint32 a item on the device) with the whole image's Hs*W terms a sum,
//   and the wrapper reduce-scatters the integers across the ranks before
//   the one conversion (ops/warp_cuda.py).  The ranks' dsrc is then the
//   whole image's B2 bit for bit.  One thread a target pixel over the
//   card, its four terms a channel added with native 64-bit atomics into
//   sums the entry zeroes (cudaMemsetAsync): integer adds commute, so the
//   order is free.  What bounds it: device-memory bytes and L2 atomics,
//   the whole source's int64 sums zeroed and written (8 B a source pixel
//   a channel) beside the slab's flow, g and dflow; a few dozen flops a
//   pixel.  Without a source gradient (a data warp) it is the dflow
//   kernel's slab instance and bins nothing.
//
// THE VECINT CHAIN (vecint2d_fwd, vecint2d_bwd)
//
// Scaling and squaring: v_0 = vec * 2^-n, then for k = 0..n-1
//   v_{k+1}[p] = v_k[p] + bilinear(v_k, p + v_k[p]),
// and its gradient, for G_n = dL/dv_n, for k = n-1..0
//   G_k = G_{k+1} + dflow_k(G_{k+1}) + dsrc_k(G_{k+1})   (src = flow = v_k),
//   dL/dvec = G_0 * 2^-n.
// What bounds it: launch and synchronisation latency.  VecInt's field at
// the main path's shape is (2,2,128,128) float32, 256 KB; each step is a
// few microseconds of dependent gathers, and as separate kernels the chain
// cost 15 launches forward and about 28 backward (B1 or B2, their adds,
// dsrc zero-fills), each with its host path.  Bytes matter only at large B.
// No batch item reads another's data, so each item is one thread-block
// cluster (cudaLaunchKernelEx with a cluster dimension; kClusterBlocks
// blocks unless the entry is given another size), and every barrier is a
// cluster barrier, where grid.sync() over the whole grid cost 1.1-1.8 us
// and a cluster barrier 0.6-0.7 us (csrc/yardsticks/sync.cu on an H100;
// chip_smoke.py).  The launch needs no cooperative grid: clusters run in
// any number of waves.
// - The forward: block r of an item's cluster owns a band of R = ceil(H /
//   size) rows (8 at 128^2 in 16 blocks), and the item's field never
//   leaves the cluster between steps: two ping-pong buffers of the band's
//   (fy, fx) pairs, 2 x R x W float2 of dynamic shared memory a block (16
//   KB at the main path's shape).  Step 0 reads vec from global memory
//   and scales each value as it reads it (v_0 = vec * 2^-n exactly), so no
//   barrier precedes it; step k > 0 reads buffer k&1: each pixel's own
//   pair from the block's buffer, each corner row's pairs from the block's
//   own buffer when the row is in the band, else from its owner's
//   (y / R as a product) through distributed shared memory
//   (cluster.map_shared_rank), with no halo limit.  Step k writes buffer
//   (k+1)&1, then one cluster barrier orders its writes before step k+1's
//   reads and its reads before step k+2's writes into the same buffer.
//   v_k goes to slot k of a saved stack (n, B, 2, H, W) when the input
//   needs a gradient, and v_n to the output; the last barrier keeps every
//   block until no peer reads its shared memory.  n barriers in all.  A
//   thread steps two pixels at once, their (y, x) advanced without a
//   division.  When two buffers of a band do not fit in kSharedBytes (R *
//   W above 6,144 pixels: at 16 blocks, an H*W above about 98,000, e.g.
//   512^2), the same kernel keeps the field in global memory, reading it
//   with __ldcg (the stack's slots, or two ping-pong fields for
//   inference), four pixels a thread at once, chosen by shape in the
//   entry; an item then runs on one cluster's 16 SMs from L2, 3.8x the
//   cooperative kernel it replaced at (1,2,512,512) (PERF.md, Findings).  What
//   bounds the shared-memory path: a step costs a cluster barrier (0.6-0.7
//   us) and a body of about 1.2 us for 1,024 pixels a SM at 128^2, where
//   the grid.sync() design spread 124-248 pixels a SM over the card; the
//   arithmetic per step is exactly B1's, so it is bit-equal to
//   vecint(..., impl="torch").
// - The backward: a block owns a run of its item's pixels, each pixel read
//   and written by the thread that owns it, so G never crosses blocks: G
//   and the own terms stay in the thread's registers when a thread owns at
//   most kRegPixels pixels (the main path's 128^2 in 16 blocks of 512),
//   else in dvec (read through L2).
//   Per step, two phases, a cluster barrier after each: (1) each pixel's
//   own terms G + dflow (B2's terms, in autograd's order) into dvec, and
//   its dsrc terms added as int64s into the sums of the pixels they land
//   on: a pixel the block owns in its shared memory (two 32-bit halves
//   with a carry), any other in the item's sums in global memory (a native
//   64-bit atomic add), so most terms (those that stay in the block's
//   rows) never leave the SM; (2) G_k = own + (both sums) * 2^-e_b at the
//   block's pixels, the sums zeroed for the next step, and max|G_k| over
//   the cluster (each block's max in its shared memory, read by the others
//   through distributed shared memory) for the next step's e_b.  The last
//   pass writes G_0 * 2^-n.
//
// Coherence: a field written earlier in the same launch by another SM is
// read with __ldcg (L2 only), never through __ldg or const __restrict__:
// the read-only / L1 path is not coherent across SMs within a launch.
// B2's sums and maxes, the backward chain's sums and the forward's fields
// in global memory are such fields; the barrier between the writes and
// the reads (grid.sync() in B2, a cluster barrier in the chains; release
// and acquire) orders them, and the chains' shared memory too.  Inputs the
// launch never writes (vec, g, src, flow, the saved stack in the
// backward) may use __ldg.  A cluster size the card refuses (above 16
// blocks) fails the chains' launch; the entry returns that error, and the
// wrapper raises.

#include <algorithm>
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
  int y0, x0;                  // top-left corner
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
  t.y0 = y0;
  t.x0 = x0;
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
  float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
};

template <bool kCoherent>
__device__ __forceinline__ Corners corners(const float* plane, long long W,
                                           const Bilinear& t) {
  Corners a;
  if (t.v00) a.a00 = load<kCoherent>(plane + t.o00);
  if (t.v01) a.a01 = load<kCoherent>(plane + t.o00 + 1);
  if (t.v10) a.a10 = load<kCoherent>(plane + t.o00 + W);
  if (t.v11) a.a11 = load<kCoherent>(plane + t.o00 + W + 1);
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

// The dsrc terms of one channel's cotangent gc, (gc * u|w_x) * u|w_y for
// each corner inside the image, each handed to add(corner's offset, the
// term in the fixed point f) as an integer.
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

// A sum's value in the fixed point f, or NaN when max|g| was not finite.
__device__ __forceinline__ float from_fixed(unsigned long long sum,
                                            const Fixed& f) {
  return f.finite ? __fmul_rn(__ll2float_rn((long long)sum), f.inv)
                  : __int_as_float(0x7fffffff);
}

// The chains' clusters: kClusterBlocks blocks a batch item unless the
// entry is given another size (at most 16).
constexpr int kClusterBlocks = 16;
// The dynamic shared memory a block of the forward chain may take for its
// two buffers of the band, so that two blocks still fit a SM; above it the
// field stays in global memory.
constexpr long long kSharedBytes = 96 * 1024;

// ------------------------------------------------------- the single warp

// kSlab: the output's H rows are rows [y0, y0 + H) of a source of Hs rows
// (a whole image: Hs = H, y0 = 0, not read).
template <bool kSlab>
__global__ void warp2d_bilinear_fwd(const float* __restrict__ src,
                                    const float* __restrict__ flow,
                                    float* __restrict__ out,
                                    int B, int C, int H, int W, int Hs,
                                    int y0) {
  const long long hw = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * hw) return;
  const int b = (int)(i / hw);
  const long long p = i - b * hw;
  const int y = (int)(p / W);
  const int x = (int)(p - (long long)y * W);

  const float* fb = flow + (long long)b * 2 * hw;
  const Bilinear t = bilinear_at(kSlab ? y + y0 : y, x, __ldg(fb + p),
                                 __ldg(fb + hw + p), kSlab ? Hs : H, W);
  const float* sb = src + (long long)b * C * (kSlab ? (long long)Hs * W : hw);
  float* ob = out + (long long)b * C * hw;
  for (int c = 0; c < C; ++c) {
    ob[(long long)c * hw + p] = blend(
        corners<false>(sb + (long long)c * (kSlab ? (long long)Hs * W : hw),
                       W, t),
        t);
  }
}

// B2 without a source gradient (the data warp): dflow alone, a thread a
// pixel over the whole card.  kSlab: the slab form, flow, g and dflow rows
// [y0, y0 + H) of an image of Hs rows (a whole image: Hs = H, y0 = 0, not
// read), and, unless `sums` is null, each pixel's dsrc terms added as
// int64s into `sums` ((B, C, Hs, W), zeroed) in item b's fixed point of
// gmax[b] over Hs * W terms.
template <bool kSlab>
__global__ void warp2d_bilinear_bwd_dflow(const float* __restrict__ src,
                                          const float* __restrict__ flow,
                                          const float* __restrict__ g,
                                          float* __restrict__ dflow,
                                          unsigned long long* __restrict__ sums,
                                          const unsigned* __restrict__ gmax,
                                          int B, int C, int H, int W, int Hs,
                                          int y0) {
  const long long hw = (long long)H * W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * hw) return;
  const int b = (int)(i / hw);
  const long long p = i - b * hw;
  const int y = (int)(p / W);
  const int x = (int)(p - (long long)y * W);

  const float* fb = flow + (long long)b * 2 * hw;
  const Bilinear t = bilinear_at(kSlab ? y + y0 : y, x, __ldg(fb + p),
                                 __ldg(fb + hw + p), kSlab ? Hs : H, W);
  const long long shw = kSlab ? (long long)Hs * W : hw;
  const long long base = (long long)b * C * hw;
  const long long sbase = (long long)b * C * shw;
  const bool binned = kSlab && sums != nullptr;
  Fixed f;
  if (binned) f = fixed_of(__ldg(gmax + b), (int)shw);
  DflowTerms terms;
  for (int c = 0; c < C; ++c) {
    const float gc = __ldg(g + base + (long long)c * hw + p);
    terms.add(gc, corners<false>(src + sbase + (long long)c * shw, W, t), t);
    if (binned) {
      unsigned long long* sc = sums + sbase + (long long)c * shw;
      scatter_fixed(gc, t, W, f, [&](int o, long long v) {
        atomicAdd(sc + o, (unsigned long long)v);
      });
    }
  }
  float* db = dflow + (long long)b * 2 * hw;
  db[p] = terms.dy();
  db[hw + p] = terms.dx();
}

// The max of m over this block's kThreads threads, in every thread.
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* sh) {
  m = __reduce_max_sync(0xffffffffu, m);
  __syncthreads();   // sh may still be read from the last call
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  m = (threadIdx.x & 31) < kThreads / 32 ? sh[threadIdx.x & 31] : 0u;
  return __reduce_max_sync(0xffffffffu, m);
}

// B2 with a source gradient over the whole card: one cooperative launch of
// `groups` x `per_item` blocks of kThreads.  Block j takes slot j %
// per_item of the items j / per_item, j / per_item + groups, ...; slot s
// of an item owns its pixels s * kThreads + i * per_item * kThreads.
// Three passes, a grid.sync() after each of the first two: (1) zero the
// owned pixels' sums (`sums`, (B, C, H, W) int64) and write the block's
// max|g| over them to maxes[b * per_item + s]; (2) e_b from item b's
// per_item maxes, each pixel's dflow and its dsrc terms added into `sums`
// (native 64-bit atomics in L2); (3) each owned pixel's sums * 2^-e_b.
__global__ void __launch_bounds__(kThreads)
    warp2d_bilinear_bwd(const float* __restrict__ src,
                        const float* __restrict__ flow,
                        const float* __restrict__ g,
                        unsigned long long* __restrict__ sums,
                        unsigned* __restrict__ maxes,
                        float* __restrict__ dsrc, float* __restrict__ dflow,
                        int B, int C, int H, int W, int per_item) {
  __shared__ unsigned sh[kThreads / 32];
  cg::grid_group grid = cg::this_grid();
  const int hw = H * W;
  const int slot = blockIdx.x % per_item;
  const int groups = gridDim.x / per_item;
  const int stride = per_item * kThreads;
  const int first = slot * kThreads + threadIdx.x;
  // e_b from item b's maxes, in every thread of the block
  auto item_fixed = [&](int b) {
    unsigned m = 0;
    for (int i = threadIdx.x; i < per_item; i += kThreads) {
      m = max(m, __ldcg(maxes + (long long)b * per_item + i));
    }
    return fixed_of(block_max(m, sh), hw);
  };

  for (int b = blockIdx.x / per_item; b < B; b += groups) {
    const long long base = (long long)b * C * hw;
    unsigned m = 0;
    for (int p = first; p < hw; p += stride) {
      for (int c = 0; c < C; ++c) {
        sums[base + (long long)c * hw + p] = 0;
        m = max(m, abs_bits(__ldg(g + base + (long long)c * hw + p)));
      }
    }
    m = block_max(m, sh);
    if (threadIdx.x == 0) maxes[(long long)b * per_item + slot] = m;
  }
  grid.sync();
  int last = -1;
  Fixed last_f;
  for (int b = blockIdx.x / per_item; b < B; b += groups) {
    const Fixed f = item_fixed(b);
    last = b;
    last_f = f;
    const long long base = (long long)b * C * hw;
    const float* fb = flow + (long long)b * 2 * hw;
    float* db = dflow + (long long)b * 2 * hw;
    for (int p = first; p < hw; p += stride) {
      const int y = p / W;
      const int x = p - y * W;
      const Bilinear t = bilinear_at(y, x, __ldg(fb + p), __ldg(fb + hw + p),
                                     H, W);
      DflowTerms terms;
      for (int c = 0; c < C; ++c) {
        const long long cb = base + (long long)c * hw;
        const float gc = __ldg(g + cb + p);
        terms.add(gc, corners<false>(src + cb, W, t), t);
        scatter_fixed(gc, t, W, f, [&](int o, long long v) {
          atomicAdd(sums + cb + o, (unsigned long long)v);
        });
      }
      db[p] = terms.dy();
      db[hw + p] = terms.dx();
    }
  }
  grid.sync();
  for (int b = blockIdx.x / per_item; b < B; b += groups) {
    const Fixed f = b == last ? last_f : item_fixed(b);
    const long long base = (long long)b * C * hw;
    for (int p = first; p < hw; p += stride) {
      for (int c = 0; c < C; ++c) {
        const long long o = base + (long long)c * hw + p;
        dsrc[o] = from_fixed(__ldcg(sums + o), f);
      }
    }
  }
}

// ----------------------------------------------------------- the chain

// Where v_k lives in global memory: with a saved stack, slot k of `steps`
// for k < n and `out` for k = n; without one, `out` and the single buffer
// `steps` alternate so that v_n lands in `out`.
__device__ __forceinline__ float* field(float* steps, float* out,
                                        long long nval, int k, int n,
                                        bool save) {
  if (save) return k == n ? out : steps + (long long)k * nval;
  return ((n - k) & 1) ? steps : out;
}

// The corners of t in both channels, from the bands of the cluster's blocks
// (`cur`, one buffer of (fy, fx) pairs; block r owns rows [r * R, (r + 1)
// * R), this block [y_lo, y_lo + R)): a row this block owns from its own
// shared memory, any other from its owner's through distributed shared
// memory.
__device__ __forceinline__ void band_corners(cg::cluster_group& cluster,
                                             float2* cur, int R, int W,
                                             int y_lo,
                                             unsigned long long magic,
                                             const Bilinear& t, Corners& a0,
                                             Corners& a1) {
  auto take = [&](const float2* row, bool left, bool right, float& l0,
                  float& r0, float& l1, float& r1) {
    if (left) {
      const float2 v = row[t.x0];
      l0 = v.x;
      l1 = v.y;
    }
    if (right) {
      const float2 v = row[t.x0 + 1];
      r0 = v.x;
      r1 = v.y;
    }
  };
  // y / R as a product: exact for y, R < 2^16
  auto owner_of = [&](int y) {
    return (int)(((unsigned long long)y * magic) >> 32);
  };
  auto read_row = [&](int y, bool left, bool right, float& l0, float& r0,
                      float& l1, float& r1) {
    if (y >= y_lo && y < y_lo + R) {
      take(cur + (y - y_lo) * W, left, right, l0, r0, l1, r1);
    } else {
      const int owner = owner_of(y);
      take(cluster.map_shared_rank(cur + (y - owner * R) * W, owner), left,
           right, l0, r0, l1, r1);
    }
  };
  if (t.v00 || t.v01) {
    read_row(t.y0, t.v00, t.v01, a0.a00, a0.a01, a1.a00, a1.a01);
  }
  if (t.v10 || t.v11) {
    read_row(t.y0 + 1, t.v10, t.v11, a0.a10, a0.a11, a1.a10, a1.a11);
  }
}

// Each corner times s.
__device__ __forceinline__ Corners scaled(Corners a, float s) {
  a.a00 = __fmul_rn(a.a00, s);
  a.a01 = __fmul_rn(a.a01, s);
  a.a10 = __fmul_rn(a.a10, s);
  a.a11 = __fmul_rn(a.a11, s);
  return a;
}

// The forward chain, one cluster a batch item b; block r owns rows [r * R,
// (r + 1) * R) of the item, R = ceil(H / size).  Step 0 reads vec from
// global memory, scaling each value as it reads it (v_0 = vec * 2^-n, an
// exact product), so it needs no barrier before it.  kShared: v_1..v_n-1
// live in the blocks' dynamic shared memory, two buffers of the band of
// (fy, fx) pairs (buffer s at s * R * W pairs), and global memory takes
// only v_n and, with `save`, the stack's slots; otherwise every v_k lives
// in global memory (`field`), read with __ldcg.  A thread steps kFwdPix of
// its block's pixels at once, their (y, x) stepped without a division.
constexpr int kFwdThreads = 512;

template <bool kShared>
__global__ void __launch_bounds__(kFwdThreads, 2)
    vecint2d_fwd(const float* __restrict__ vec, float* steps, float* out,
                 int B, int H, int W, int nsteps, int save, float scale) {
  // pixels a thread steps at once: more from L2, to keep more in flight
  constexpr int kFwdPix = kShared ? 2 : 4;
  extern __shared__ float2 band[];
  cg::cluster_group cluster = cg::this_cluster();
  const int size = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / size;
  const int hw = H * W;
  const int R = (H + size - 1) / size;
  const int y_lo = min(rank * R, H);
  const int first = y_lo * W;                   // the block's first pixel
  const int n = min(y_lo + R, H) * W - first;   // and its pixels
  const long long nval = 2LL * B * hw;
  const long long item = 2LL * b * hw;
  const float* vb = vec + item;

  if (nsteps == 0) {   // out = vec; no block reads another's memory
    for (int q = threadIdx.x; q < n; q += kFwdThreads) {
      out[item + first + q] = __ldg(vb + first + q);
      out[item + hw + first + q] = __ldg(vb + hw + first + q);
    }
    return;
  }
  const unsigned long long magic = ((1ull << 32) + R - 1) / R;
  const int step_y = kFwdThreads / W;
  const int step_x = kFwdThreads - step_y * W;
  const int y_first = y_lo + (int)threadIdx.x / W;
  const int x_first = (int)threadIdx.x - ((int)threadIdx.x / W) * W;
  float* v0 = save ? steps + item : nullptr;
  for (int k = 0; k < nsteps; ++k) {
    const bool last = k + 1 == nsteps;
    float2* cur = band + (k & 1) * R * W;
    float2* nxt = band + ((k + 1) & 1) * R * W;
    const float* v = field(steps, out, nval, k, nsteps, save) + item;
    float* next = field(steps, out, nval, k + 1, nsteps, save) + item;
    const bool to_global = !kShared || save || last;
    int y = y_first, x = x_first;
    for (int q0 = threadIdx.x; q0 < n; q0 += kFwdPix * kFwdThreads) {
      float n0[kFwdPix], n1[kFwdPix];
#pragma unroll
      for (int i = 0; i < kFwdPix; ++i) {
        const int q = q0 + i * kFwdThreads;
        if (q >= n) break;
        const int p = first + q;
        float fy, fx;
        Corners a0, a1;
        Bilinear t;
        if (k == 0) {
          fy = __fmul_rn(__ldg(vb + p), scale);
          fx = __fmul_rn(__ldg(vb + hw + p), scale);
          if (v0 != nullptr) {
            __stcg(v0 + p, fy);
            __stcg(v0 + hw + p, fx);
          }
          t = bilinear_at(y, x, fy, fx, H, W);
          a0 = corners<false>(vb, W, t);
          a1 = corners<false>(vb + hw, W, t);
          a0 = scaled(a0, scale);
          a1 = scaled(a1, scale);
        } else if constexpr (kShared) {
          const float2 own = cur[q];
          fy = own.x;
          fx = own.y;
          t = bilinear_at(y, x, fy, fx, H, W);
          band_corners(cluster, cur, R, W, y_lo, magic, t, a0, a1);
        } else {
          fy = __ldcg(v + p);
          fx = __ldcg(v + hw + p);
          t = bilinear_at(y, x, fy, fx, H, W);
          a0 = corners<true>(v, W, t);
          a1 = corners<true>(v + hw, W, t);
        }
        n0[i] = __fadd_rn(fy, blend(a0, t));
        n1[i] = __fadd_rn(fx, blend(a1, t));
        y += step_y;
        x += step_x;
        if (x >= W) {
          x -= W;
          ++y;
        }
      }
#pragma unroll
      for (int i = 0; i < kFwdPix; ++i) {
        const int q = q0 + i * kFwdThreads;
        if (q >= n) break;
        if (kShared && !last) nxt[q] = make_float2(n0[i], n1[i]);
        if (to_global) {
          __stcg(next + first + q, n0[i]);
          __stcg(next + hw + first + q, n1[i]);
        }
      }
    }
    // kShared: after the last step too, so that no block leaves while a
    // peer still reads its shared memory
    if (kShared || !last) cluster.sync();
  }
}

// The backward chain's block: kClusterThreads threads.
constexpr int kClusterThreads = 512;
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

int b2_resident[kMaxDevices];

}  // namespace

// src (B,C,H,W), flow (B,2,H,W), out (B,C,H,W): float32, contiguous, on the
// device of `stream`.  src and flow may alias; out must not.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int dfmir_warp2d_fwd(const float* src, const float* flow,
                                float* out, int B, int C, int H, int W,
                                void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  warp2d_bilinear_fwd<false>
      <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
          src, flow, out, B, C, H, W, H, 0);
  return (int)cudaGetLastError();
}

// B1 on a row slab: flow (B,2,H,W) and out (B,C,H,W) are rows [y0, y0 + H)
// of an image of Hs rows, src (B,C,Hs,W) the whole image; out's row y
// samples the source at row (y + y0) + flow_y, clamped to [-2, Hs+1].
// Otherwise as dfmir_warp2d_fwd.
extern "C" int dfmir_warp2d_fwd_slab(const float* src, const float* flow,
                                     float* out, int B, int C, int H, int W,
                                     int Hs, int y0, void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  if (y0 < 0 || y0 + H > Hs) return (int)cudaErrorInvalidValue;
  warp2d_bilinear_fwd<true>
      <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
          src, flow, out, B, C, H, W, Hs, y0);
  return (int)cudaGetLastError();
}

// The int64s of the scratch that dfmir_warp2d_bwd needs for a source
// gradient of (B,C,H,W): the (B,C,H,W) sums, then the per-block maxes.
extern "C" long long dfmir_warp2d_bwd_scratch(int B, int C, int H, int W) {
  const long long slots = (long long)B * (((long long)H * W + kThreads - 1) /
                                          kThreads);
  return (long long)B * C * H * W + (slots + 1) / 2;
}

// Backward of dfmir_warp2d_fwd.  src (B,C,H,W), flow (B,2,H,W), g (B,C,H,W)
// the output's cotangent; writes dflow (B,2,H,W) and, unless dsrc is null,
// dsrc (B,C,H,W), bitwise the same on every run.  `scratch` is int64 of
// dfmir_warp2d_bwd_scratch's size (unused without dsrc), set by the
// launch.  float32, contiguous, on the device of `stream`.  src and flow
// may alias; dsrc, dflow and scratch alias nothing.  Returns the launch's
// cudaError_t.
extern "C" int dfmir_warp2d_bwd(const float* src, const float* flow,
                                const float* g, float* dsrc, float* dflow,
                                unsigned long long* scratch, int B, int C,
                                int H, int W, void* stream) {
  const long long n = (long long)B * H * W;
  if (n == 0) return (int)cudaSuccess;
  if (dsrc == nullptr) {
    warp2d_bilinear_bwd_dflow<false><<<blocks_for(n), kThreads, 0,
                                       (cudaStream_t)stream>>>(
        src, flow, g, dflow, nullptr, nullptr, B, C, H, W, H, 0);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)warp2d_bilinear_bwd;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, b2_resident, &resident);
  if (err != cudaSuccess) return (int)err;
  const int hw = H * W;
  const int per_item = (int)std::min<long long>(
      (hw + kThreads - 1) / kThreads, std::max(1, resident / B));
  const int groups = std::min(B, std::max(1, resident / per_item));
  unsigned* maxes = (unsigned*)(scratch + (long long)B * C * hw);
  void* args[] = {&src, &flow, &g, &scratch, &maxes, &dsrc, &dflow,
                  &B, &C, &H, &W, (void*)&per_item};
  return (int)launch_chain(kernel, b2_resident, 0, groups * per_item, args,
                           stream);
}

// The int64s of the sums dfmir_warp2d_bwd_slab writes for a source of
// (B,C,Hs,W): one a source pixel a channel.
extern "C" long long dfmir_warp2d_bwd_slab_sums(int B, int C, int Hs,
                                                int W) {
  return (long long)B * C * Hs * W;
}

// B2 on a row slab: flow (B,2,H,W) and g (B,C,H,W) are rows [y0, y0 + H)
// of an image of Hs rows, src (B,C,Hs,W) the whole image; writes dflow
// (B,2,H,W), the whole image's dflow rows bit for bit, and, unless sums is
// null, sums (B,C,Hs,W) int64 (dfmir_warp2d_bwd_slab_sums' size, zeroed
// here): each source pixel's sum of the slab's dsrc terms in item b's
// fixed point of gmax[b] (a device uint32 a batch item: the bits of
// max|g[b]| over the whole image's cotangent) and Hs*W terms, unconverted.
// float32, contiguous, on the device of `stream`; src and flow may alias,
// dflow and sums alias nothing.  Returns the launch's cudaError_t.
extern "C" int dfmir_warp2d_bwd_slab(const float* src, const float* flow,
                                     const float* g, float* dflow,
                                     unsigned long long* sums,
                                     const unsigned* gmax, int B, int C,
                                     int H, int W, int Hs, int y0,
                                     void* stream) {
  if (y0 < 0 || y0 + H > Hs) return (int)cudaErrorInvalidValue;
  if (sums != nullptr && gmax == nullptr) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  if (sums != nullptr) {
    const cudaError_t err = cudaMemsetAsync(
        sums, 0, sizeof(unsigned long long) * B * C * (long long)Hs * W,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0) return (int)cudaSuccess;
  warp2d_bilinear_bwd_dflow<true><<<blocks_for(n), kThreads, 0,
                                      (cudaStream_t)stream>>>(
      src, flow, g, dflow, sums, gmax, B, C, H, W, Hs, y0);
  return (int)cudaGetLastError();
}

// VecInt forward: vec (B,2,H,W) -> out (B,2,H,W), nsteps squarings.  With
// `save`, `steps` is (nsteps,B,2,H,W) and receives v_0..v_{n-1}; without, it
// is one (B,2,H,W) buffer (unused when nsteps is 0, and when the field
// stays in the clusters' shared memory).  `cluster` is the blocks of a
// batch item's cluster (0: kClusterBlocks); a size the card refuses (above
// 16) fails the launch.  float32, contiguous, on the device of `stream`;
// no buffer aliases another.  Returns the launch's cudaError_t.
extern "C" int dfmir_vecint2d_fwd(const float* vec, float* steps, float* out,
                                  int B, int H, int W, int nsteps, int save,
                                  int cluster, void* stream) {
  if ((long long)B * H * W == 0) return (int)cudaSuccess;
  if (cluster == 0) cluster = kClusterBlocks;
  if (cluster < 1) return (int)cudaErrorInvalidValue;
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&vec, &steps, &out, &B, &H, &W, &nsteps, &save, &scale};
  // two buffers of a band of two channels in each block's shared memory
  const long long bytes = 16LL * ((H + cluster - 1) / cluster) * W;
  if (bytes <= kSharedBytes && H < (1 << 16)) {
    return (int)launch_clusters((const void*)vecint2d_fwd<true>, kFwdThreads,
                                B, cluster, (int)bytes, args, stream);
  }
  return (int)launch_clusters((const void*)vecint2d_fwd<false>, kFwdThreads,
                              B, cluster, 0, args, stream);
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
  return (int)launch_clusters(kernel, kClusterThreads, B, cluster, 0, args,
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
