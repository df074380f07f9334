// 3-D trilinear warp for Hopper (sm_90a): the single warp's forward (B3),
// flow gradient (B4, dflow) and source gradient (B5, dsrc), and VecInt's
// 3-D scaling-and-squaring chain as one cooperative launch each way
// (vecint3d_fwd, vecint3d_bwd).
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
//   vecint3d_fwd                <- _kernel3d, called 7 times by JAX's vecint
//                                  (dfmir_tpu/ops/integrate.py:82-95)
//   vecint3d_bwd                <- _bwd_kernel3d_dflow and _dsrc, 7 times
//                                  each by jax.vjp of it
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
// THE PER-VOXEL CORE, shared by all five kernels.  What bounds the single
// warps is device-memory bytes and the latency of dependent gathers: at the
// 160^3 data warp a launch moves 82 MB (B3) or 131 MB (B4), and each voxel
// reads its flow, then gathers 8 corners a channel that depend on it.  The
// first design (one voxel a thread, 64-bit offsets for each of the 8
// corners, 24 accumulators in B4) took 48 registers for B3 and 72 for B4
// and ran at 36-41% of the byte bound.  This one keeps a thread's state
// small and its loads many:
// - Trilinear holds one 32-bit offset (corner 0's, which may be negative
//   for a clamped coordinate) and an 8-bit validity mask; corner k's offset
//   is base + (k>>2)*H*W + ((k>>1)&1)*W + (k&1), all int (the wrapper keeps
//   B * max(C, 3) * D * H * W below 2^31, so int is exact);
// - a thread takes two voxels of one row, x and x + ceil(W/2), decoded
//   from a 32-bit index, so twice the independent gathers are in flight;
//   the two are half a row apart, not neighbours, so that each warp
//   instruction (a flow load, a corner gather, a store, an atomic) still
//   covers consecutive voxels: with neighbouring pairs (x, x+1) the
//   atomics of B5 touched twice the lines per instruction and B5 ran at
//   1.7x its earlier time; an odd row's second voxel past the end has a
//   zero flow and no corner inside (no loads, no store);
// - B4 walks the corners 7..0 in turn, sums each corner's terms over the
//   channels, and folds them at once into dz, dy, dx (five partial sums in
//   place of 24 accumulators); at C = 1 (the data warp) the cotangent is
//   held in a register, at any other C read again for each corner;
// - loads are templated on their path (Path below).
// Register caps (__launch_bounds__' minimum blocks a SM) were chosen on the
// H100 by device time: 4 blocks (<= 64 registers) for B3 and B5, none for
// the others; tighter caps made ptxas spill, and the kernels ran slower.
// ptxas (-Xptxas -v): B3 64, B4 45 (C = 1) / 64, B5 63, vecint3d_fwd 64,
// vecint3d_bwd 80 registers, no spills.
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
// THE SINGLE WARP (B3, B4, B5).  dflow and dsrc are separate launches, as on
// the TPU: the data warp (source without a gradient) launches dflow alone
// and never zero-fills a dsrc.  src and flow may alias: the kernels only
// read them and write fresh buffers.
//
// THE VECINT CHAIN (vecint3d_fwd, vecint3d_bwd).  Scaling and squaring,
// v_0 = vec * 2^-n, then for k = 0..n-1
//   v_{k+1}[p] = v_k[p] + trilinear(v_k, p + v_k[p]),
// and its gradient, for G_n = dL/dv_n, for k = n-1..0
//   G_k = G_{k+1} + dflow_k(G_{k+1}) + dsrc_k(G_{k+1})   (src = flow = v_k),
//   dL/dvec = G_0 * 2^-n.
// As 7 launches each way the chain cost about 15 launches forward (B3 and
// an add a step) and 36 backward (B4, a zero-fill and B5, and autograd's
// two adds a step), each with its host path; its field at VecInt's
// (1,3,80,80,80) is 6.1 MB and the saved stack of 7 fields 43 MB, within
// the 50 MB L2.  Design, as the 2-D chain's (csrc/warp2d.cu): one
// cooperative launch (csrc/chain_launch.cuh) with a grid capped at the
// blocks the card holds at once, a grid-stride loop over voxel pairs, and
// grid.sync() between steps.  The forward writes v_k into slot k of a
// stack of n slots, each a (B, 3, D, H, W) field padded to a multiple of 32
// floats, which the backward reads, and v_n into the output; it does so for
// inference too, so that every field is written once and only then read.
// The backward writes each voxel's own terms
// (G + dflow) into a fresh buffer, syncs, scatters dsrc into it with
// atomics, syncs, and swaps (no zero-fill, no separate adds); then scales
// by 2^-n in place.  Per voxel the arithmetic is B3's, B4's and B5's, so
// the forward chain is bit-equal to vecint(..., impl="torch").
//
// Coherence.  The L1 caches of the SMs are not coherent with each other;
// they are invalidated between kernel launches.  The forward reads v_k
// through L1 (__ldca): slot k is written once, and no SM can hold a stale
// copy of it, because every slot starts on a 128-byte line (the padded
// stride and a line-aligned stack; the entry checks both), so no sector of
// it was read before it was written.  The corner gathers then hit L1 as
// B3's do; reading them from L2 alone (__ldcg) made the chain take twice 7
// B3 launches.  The backward's G_{k+1} is rewritten every other step and
// is read at each voxel's own place only, from L2.
// vec and, in the backward, the saved stack (written by an earlier launch)
// take the read-only path (__ldg).  A grid larger than the co-resident
// limit makes the launch fail; the entry returns that error and the
// wrapper raises.

#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chain_launch.cuh"

namespace cg = cooperative_groups;

namespace {

// The path of a load: the read-only path (a buffer no thread writes in the
// launch), L2 alone (a buffer written earlier in the launch), or L1 (a
// write-once slot; see the notes on coherence).
enum class Path { kReadOnly, kL2, kL1 };

template <Path kPath>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kPath == Path::kL2) return __ldcg(p);
  if constexpr (kPath == Path::kL1) return __ldca(p);
  return __ldg(p);
}

// One voxel's corners and weights.
struct Trilinear {
  int base;          // corner 0's offset in a (D, H, W) plane (may be < 0)
  unsigned mask;     // bit k: corner k lies inside the volume
  float wz, wy, wx;  // the high corners' weights; the low corners' 1 - w
};

// f = 1 - w for the low corner (d = 0), w for the high one.
__device__ __forceinline__ float weight(float w, int d) {
  return d ? w : 1.0f - w;
}

// Corner k's offset from corner 0.
__device__ __forceinline__ int corner(int k, int hw, int W) {
  return (k >> 2) * hw + ((k >> 1) & 1) * W + (k & 1);
}

__device__ __forceinline__ float clamp_coord(float v, int size) {
  return fminf(fmaxf(v, -2.0f), (float)size + 1.0f);
}

__device__ __forceinline__ unsigned inside(int i, int size) {
  return (unsigned)(i >= 0 && i <= size - 1) |
         (unsigned)(i + 1 >= 0 && i + 1 <= size - 1) << 1;
}

// Voxel (z, y, x) displaced by (uz, uy, ux).
__device__ __forceinline__ Trilinear trilinear(int z, int y, int x, float uz,
                                               float uy, float ux, int D,
                                               int H, int W) {
  const float zs = clamp_coord((float)z + uz, D);
  const float ys = clamp_coord((float)y + uy, H);
  const float xs = clamp_coord((float)x + ux, W);
  const float z0f = floorf(zs), y0f = floorf(ys), x0f = floorf(xs);
  const int z0 = (int)z0f, y0 = (int)y0f, x0 = (int)x0f;
  const unsigned mz = inside(z0, D), my = inside(y0, H), mx = inside(x0, W);
  Trilinear t;
  t.wz = zs - z0f;
  t.wy = ys - y0f;
  t.wx = xs - x0f;
  t.mask = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t.mask |= ((mz >> (k >> 2)) & (my >> ((k >> 1) & 1)) & (mx >> (k & 1)) &
               1u) << k;
  }
  t.base = (z0 * H + y0) * W + x0;
  return t;
}

// The voxel pair of work item j: x and x + ceil(W/2) of one row, the
// second only when it lies inside the row.
struct Pair {
  int b, z, y, x;
  int p;      // the first voxel's offset in a (D, H, W) plane
  int half;   // the second's offset from the first, ceil(W/2)
  bool two;
};

__device__ __forceinline__ Pair pair_at(int j, int D, int H, int W) {
  Pair q;
  q.half = (W + 1) >> 1;
  int row = j / q.half;
  q.x = j - row * q.half;
  q.y = row % H;
  row /= H;
  q.z = row % D;
  q.b = row / D;
  q.p = (q.z * H + q.y) * W + q.x;
  q.two = q.x + q.half < W;
  return q;
}

// The pair's values in a plane at the first voxel's place p (the second's
// 0 unless it lies inside the row).
template <Path kPath>
__device__ __forceinline__ float2 load2(const float* p, const Pair& q) {
  return make_float2(ld<kPath>(p), q.two ? ld<kPath>(p + q.half) : 0.0f);
}

// Store the pair's values at p; kL2: through L2 alone, for a field read
// later in the same launch.
template <bool kL2>
__device__ __forceinline__ void store2(float* p, float2 v, const Pair& q) {
  if (kL2) {
    __stcg(p, v.x);
    if (q.two) __stcg(p + q.half, v.y);
  } else {
    p[0] = v.x;
    if (q.two) p[q.half] = v.y;
  }
}

// The two voxels' displacements, (z, y, x) each, from the field fb (the
// batch's 3 planes, dhw apart), and their Trilinear.
template <Path kPath>
__device__ __forceinline__ void trilinear_pair(const float* fb, const Pair& q,
                                               int dhw, int D, int H, int W,
                                               float2 (&u)[3],
                                               Trilinear (&t)[2]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = load2<kPath>(fb + a * dhw + q.p, q);
  t[0] = trilinear(q.z, q.y, q.x, u[0].x, u[1].x, u[2].x, D, H, W);
  t[1] = trilinear(q.z, q.y, q.x + q.half, u[0].y, u[1].y, u[2].y, D, H,
                   W);
}

// B3: one voxel's sample of `plane`, the corners summed in the plain
// version's order.
template <Path kPath>
__device__ __forceinline__ float blend(const float* plane, const Trilinear& t,
                                       int hw, int W) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = (t.mask >> k) & 1u
                        ? ld<kPath>(plane + (t.base + corner(k, hw, W)))
                        : 0.0f;
    const float term = __fmul_rn(
        __fmul_rn(__fmul_rn(v, weight(t.wz, k >> 2)),
                  weight(t.wy, (k >> 1) & 1)),
        weight(t.wx, k & 1));
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  return acc;
}

// B4: one voxel's flow gradient (dz, dy, dx), summed over the C channel
// planes of `src` (dhw apart); gc(c) is channel c's cotangent at the voxel.
// Corners 7..0 in turn: each corner's X, Y, Z summed over the channels in
// channel order, then folded into the partial sums in autograd's order.
template <typename G>
__device__ __forceinline__ float3 dflow_at(const float* src, int C, int dhw,
                                           int hw, int W, const Trilinear& t,
                                           G gc) {
  float dx = 0.0f, ya = 0.0f, yb = 0.0f, za = 0.0f, zb = 0.0f;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    const float fz = weight(t.wz, k >> 2), fy = weight(t.wy, (k >> 1) & 1),
                fx = weight(t.wx, k & 1);
    const bool in = (t.mask >> k) & 1u;
    const int o = t.base + corner(k, hw, W);
    float X = 0.0f, Y = 0.0f, Z = 0.0f;
#pragma unroll   // fully when C is a compile-time constant, else not at all
    for (int c = 0; c < C; ++c) {
      const float g = gc(c);
      const float v = in ? __ldg(src + (c * dhw + o)) : 0.0f;
      const float vz = __fmul_rn(v, fz);
      const float gx = __fmul_rn(g, fx);
      X = __fadd_rn(X, __fmul_rn(g, __fmul_rn(vz, fy)));
      Y = __fadd_rn(Y, __fmul_rn(gx, vz));
      Z = __fadd_rn(Z, __fmul_rn(__fmul_rn(gx, fy), v));
    }
    // dx = X7 - X6 + X5 - ... - X0
    dx = k == 7 ? X : (k & 1) ? __fadd_rn(dx, X) : __fsub_rn(dx, X);
    // dy = (((Y7 + Y6) - (Y5 + Y4)) + Y3 + Y2) - (Y1 + Y0)
    if (k == 7) {
      ya = Y;
    } else if (k == 6 || k == 3 || k == 2) {
      ya = __fadd_rn(ya, Y);
    } else if (k == 5 || k == 1) {
      yb = Y;
    } else {  // k == 4 or 0
      ya = __fsub_rn(ya, __fadd_rn(yb, Y));
    }
    // dz = (((Z7 + Z6) + Z5) + Z4) - (((Z3 + Z2) + Z1) + Z0)
    if (k == 7) {
      za = Z;
    } else if (k >= 4) {
      za = __fadd_rn(za, Z);
    } else if (k == 3) {
      zb = Z;
    } else {
      zb = __fadd_rn(zb, Z);
    }
  }
  return make_float3(__fsub_rn(za, zb), ya, dx);
}

// B5: one voxel's scatter of the cotangent gc into a dsrc plane.
__device__ __forceinline__ void scatter_at(float* plane, float gc,
                                           const Trilinear& t, int hw,
                                           int W) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!((t.mask >> k) & 1u)) continue;
    const float w = __fmul_rn(
        __fmul_rn(__fmul_rn(gc, weight(t.wx, k & 1)),
                  weight(t.wy, (k >> 1) & 1)),
        weight(t.wz, k >> 2));
    atomicAdd(plane + (t.base + corner(k, hw, W)), w);
  }
}

// ------------------------------------------------------- the single warp

__global__ void __launch_bounds__(kThreads, 4)
    warp3d_trilinear_fwd(const float* __restrict__ src,
                         const float* __restrict__ flow,
                         float* __restrict__ out, int npairs, int C, int D,
                         int H, int W) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= npairs) return;
  const Pair q = pair_at(j, D, H, W);
  const int hw = H * W, dhw = D * hw;
  float2 u[3];
  Trilinear t[2];
  trilinear_pair<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw, D, H, W, u,
                                  t);
  for (int c = 0; c < C; ++c) {
    const int plane = (q.b * C + c) * dhw;
    const float* sp = src + plane;
    store2<false>(out + plane + q.p,
                  make_float2(blend<Path::kReadOnly>(sp, t[0], hw, W),
                              blend<Path::kReadOnly>(sp, t[1], hw, W)),
                  q);
  }
}

// kOne: C is 1 (the data warp), its cotangent then read once and held in
// a register; otherwise it is read again for each corner, from L1.  The
// loop over channels is then a runtime loop, the corner gathers are no
// longer issued together, and B4 at the 160^3 data warp took 2x the time
// (119.8-120.5 against 57.7-58.7 us of device time, chip_smoke.py's phase
// kernel3d on an NVIDIA H100 80GB HBM3 at 700 W), hence the case of its
// own.
template <bool kOne>
__global__ void __launch_bounds__(kThreads)
    warp3d_trilinear_bwd_dflow(const float* __restrict__ src,
                               const float* __restrict__ flow,
                               const float* __restrict__ g,
                               float* __restrict__ dflow, int npairs, int C,
                               int D, int H, int W) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= npairs) return;
  const Pair q = pair_at(j, D, H, W);
  const int hw = H * W, dhw = D * hw;
  const int nc = kOne ? 1 : C;
  float2 u[3];
  Trilinear t[2];
  trilinear_pair<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw, D, H, W, u,
                                  t);
  const float* sb = src + q.b * nc * dhw;
  const float* gb = g + q.b * nc * dhw + q.p;
  float3 d0, d1;
  if constexpr (kOne) {
    const float2 gv = load2<Path::kReadOnly>(gb, q);
    d0 = dflow_at(sb, 1, dhw, hw, W, t[0], [&](int) { return gv.x; });
    d1 = dflow_at(sb, 1, dhw, hw, W, t[1], [&](int) { return gv.y; });
  } else {
    const int half = q.half;
    const bool two = q.two;
    d0 = dflow_at(sb, nc, dhw, hw, W, t[0],
                  [&](int c) { return __ldg(gb + c * dhw); });
    d1 = dflow_at(sb, nc, dhw, hw, W, t[1], [&](int c) {
      return two ? __ldg(gb + c * dhw + half) : 0.0f;
    });
  }
  float* db = dflow + q.b * 3 * dhw + q.p;
  store2<false>(db, make_float2(d0.x, d1.x), q);
  store2<false>(db + dhw, make_float2(d0.y, d1.y), q);
  store2<false>(db + 2 * dhw, make_float2(d0.z, d1.z), q);
}

__global__ void __launch_bounds__(kThreads, 4)
    warp3d_trilinear_bwd_dsrc(const float* __restrict__ flow,
                              const float* __restrict__ g,
                              float* __restrict__ dsrc, int npairs, int C,
                              int D, int H, int W) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= npairs) return;
  const Pair q = pair_at(j, D, H, W);
  const int hw = H * W, dhw = D * hw;
  float2 u[3];
  Trilinear t[2];
  trilinear_pair<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw, D, H, W, u,
                                  t);
  for (int c = 0; c < C; ++c) {
    const int plane = (q.b * C + c) * dhw;
    const float2 gv = load2<Path::kReadOnly>(g + plane + q.p, q);
    scatter_at(dsrc + plane, gv.x, t[0], hw, W);
    scatter_at(dsrc + plane, gv.y, t[1], hw, W);  // no corner unless two
  }
}

// ----------------------------------------------------------- the chain

// Slot k of `steps` starts at k * slot floats.
__global__ void __launch_bounds__(kThreads)
    vecint3d_fwd(const float* __restrict__ vec, float* steps, long long slot,
                 float* out, int npairs, int B, int D, int H, int W,
                 int nsteps, float scale) {
  cg::grid_group grid = cg::this_grid();
  const int hw = H * W, dhw = D * hw;
  const long long nval = 3LL * B * dhw;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;

  float* v0 = nsteps ? steps : out;
  for (long long j = first; j < nval; j += stride) {
    __stcg(v0 + j, __fmul_rn(__ldg(vec + j), scale));
  }
  for (int k = 0; k < nsteps; ++k) {
    grid.sync();
    const float* v = steps + k * slot;
    float* next = k + 1 == nsteps ? out : steps + (k + 1) * slot;
    for (int j = first; j < npairs; j += stride) {
      const Pair q = pair_at(j, D, H, W);
      const float* vb = v + q.b * 3 * dhw;
      float2 u[3];
      Trilinear t[2];
      trilinear_pair<Path::kL1>(vb, q, dhw, D, H, W, u, t);
      float* nb = next + q.b * 3 * dhw + q.p;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float* plane = vb + a * dhw;
        store2<true>(
            nb + a * dhw,
            make_float2(
                __fadd_rn(u[a].x, blend<Path::kL1>(plane, t[0], hw, W)),
                __fadd_rn(u[a].y, blend<Path::kL1>(plane, t[1], hw, W))),
            q);
      }
    }
  }
}

// G_{k+1} is `gin`; G_k is built in `acc`: the last step's acc is dvec, and
// dvec and the single buffer `scratch` alternate before it.
__global__ void __launch_bounds__(kThreads)
    vecint3d_bwd(const float* __restrict__ steps, long long slot,
                 const float* __restrict__ g, float* scratch, float* dvec,
                 int npairs, int B, int D, int H, int W, int nsteps,
                 float scale) {
  cg::grid_group grid = cg::this_grid();
  const int hw = H * W, dhw = D * hw;
  const long long nval = 3LL * B * dhw;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;

  const float* gin = g;
  for (int k = nsteps - 1; k >= 0; --k) {
    const float* v = steps + k * slot;
    float* acc = (k & 1) ? scratch : dvec;
    // each voxel's own terms: acc = G + dflow
    for (int j = first; j < npairs; j += stride) {
      const Pair q = pair_at(j, D, H, W);
      const float* vb = v + q.b * 3 * dhw;
      float2 u[3], gv[3];
      Trilinear t[2];
      trilinear_pair<Path::kReadOnly>(vb, q, dhw, D, H, W, u, t);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gv[a] = load2<Path::kL2>(gin + (q.b * 3 + a) * dhw + q.p, q);
      }
      const float g0[3] = {gv[0].x, gv[1].x, gv[2].x};
      const float g1[3] = {gv[0].y, gv[1].y, gv[2].y};
      const float3 d0 = dflow_at(vb, 3, dhw, hw, W, t[0],
                                 [&](int c) { return g0[c]; });
      const float3 d1 = dflow_at(vb, 3, dhw, hw, W, t[1],
                                 [&](int c) { return g1[c]; });
      float* ab = acc + q.b * 3 * dhw + q.p;
      store2<true>(ab, make_float2(__fadd_rn(g0[0], d0.x),
                                   __fadd_rn(g1[0], d1.x)), q);
      store2<true>(ab + dhw, make_float2(__fadd_rn(g0[1], d0.y),
                                         __fadd_rn(g1[1], d1.y)), q);
      store2<true>(ab + 2 * dhw, make_float2(__fadd_rn(g0[2], d0.z),
                                             __fadd_rn(g1[2], d1.z)), q);
    }
    grid.sync();
    // then every voxel's dsrc scattered into the others
    for (int j = first; j < npairs; j += stride) {
      const Pair q = pair_at(j, D, H, W);
      float2 u[3];
      Trilinear t[2];
      trilinear_pair<Path::kReadOnly>(v + q.b * 3 * dhw, q, dhw, D, H, W, u,
                                      t);
      float* ab = acc + q.b * 3 * dhw;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float2 gv = load2<Path::kL2>(gin + (q.b * 3 + a) * dhw + q.p,
                                           q);
        scatter_at(ab + a * dhw, gv.x, t[0], hw, W);
        scatter_at(ab + a * dhw, gv.y, t[1], hw, W);
      }
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

// The voxel pairs of B volumes of (D, H, W).
long long pairs_of(int B, int D, int H, int W) {
  return (long long)B * D * H * ((W + 1) / 2);
}

bool on_line(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 128 == 0;
}

// co-resident blocks of each chain kernel, per device
int fwd_resident[kMaxDevices];
int bwd_resident[kMaxDevices];

}  // namespace

// src (B,C,D,H,W), flow (B,3,D,H,W), out (B,C,D,H,W): float32, contiguous,
// on the device of `stream`.  src and flow may alias; out must not.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int dfmir_warp3d_fwd(const float* src, const float* flow,
                                float* out, int B, int C, int D, int H, int W,
                                void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0 || C == 0) return (int)cudaSuccess;
  warp3d_trilinear_fwd<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      src, flow, out, (int)n, C, D, H, W);
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
  const long long n = pairs_of(B, D, H, W);
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 1) {
    warp3d_trilinear_bwd_dflow<true><<<blocks_for(n), kThreads, 0, s>>>(
        src, flow, g, dflow, (int)n, C, D, H, W);
  } else {
    warp3d_trilinear_bwd_dflow<false><<<blocks_for(n), kThreads, 0, s>>>(
        src, flow, g, dflow, (int)n, C, D, H, W);
  }
  return (int)cudaGetLastError();
}

// The source gradient of dfmir_warp3d_fwd for the output cotangent g
// (B,C,D,H,W): writes dsrc (B,C,D,H,W), zeroed here on `stream` before the
// scatter.  Needs no source values.  float32, contiguous, on the device of
// `stream`; dsrc must not alias flow or g.  Returns the first cudaError_t.
extern "C" int dfmir_warp3d_bwd_dsrc(const float* flow, const float* g,
                                     float* dsrc, int B, int C, int D, int H,
                                     int W, void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0 || C == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      dsrc, 0, sizeof(float) * B * C * D * H * W, s);
  if (err != cudaSuccess) return (int)err;
  warp3d_trilinear_bwd_dsrc<<<blocks_for(n), kThreads, 0, s>>>(
      flow, g, dsrc, (int)n, C, D, H, W);
  return (int)cudaGetLastError();
}

// VecInt forward: vec (B,3,D,H,W) -> out (B,3,D,H,W), nsteps squarings.
// `steps` receives v_0..v_{n-1}, field k at k * slot floats (the backward's
// input; unused when nsteps is 0): `slot` a multiple of 32 no smaller than
// a field, `steps` on a 128-byte line, else cudaErrorInvalidValue.
// `blocks` 0 sizes the grid to the co-resident limit.  float32, contiguous,
// on the device of `stream`; no buffer aliases another.  Returns the
// launch's cudaError_t.
extern "C" int dfmir_vecint3d_fwd(const float* vec, float* steps,
                                  long long slot, float* out, int B, int D,
                                  int H, int W, int nsteps, int blocks,
                                  void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0) return (int)cudaSuccess;
  if (nsteps > 0 && (slot % 32 != 0 || slot < 3LL * B * D * H * W ||
                     !on_line(steps))) {
    return (int)cudaErrorInvalidValue;    // a slot off its line: stale L1
  }
  int npairs = (int)n;
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&vec, &steps, &slot, &out, &npairs, &B,
                  &D,   &H,     &W,    &nsteps, &scale};
  return (int)launch_chain((const void*)vecint3d_fwd, fwd_resident, n,
                           blocks, args, stream);
}

// VecInt backward: steps the forward's saved v_0..v_{n-1}, field k at k *
// slot floats; g (B,3,D,H,W) the cotangent of v_n; writes dvec
// (B,3,D,H,W).  `scratch` is one (B,3,D,H,W) buffer (unused when nsteps <
// 2).  `blocks` as in the forward.  float32, contiguous, on the device of
// `stream`; dvec and scratch alias nothing.  Returns the launch's
// cudaError_t.
extern "C" int dfmir_vecint3d_bwd(const float* steps, long long slot,
                                  const float* g, float* scratch, float* dvec,
                                  int B, int D, int H, int W, int nsteps,
                                  int blocks, void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0) return (int)cudaSuccess;
  int npairs = (int)n;
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&steps, &slot, &g, &scratch, &dvec, &npairs,
                  &B,     &D,    &H, &W,       &nsteps, &scale};
  return (int)launch_chain((const void*)vecint3d_bwd, bwd_resident, n,
                           blocks, args, stream);
}
