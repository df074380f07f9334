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
//                                  (and its slab form, _slab)
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
// THE PER-VOXEL CORE, shared by B3, B4, B5 and vecint3d_bwd.  What bounds the
// single warps is device-memory bytes and the latency of dependent gathers: at
// the 160^3 data warp a launch moves 82 MB (B3) or 131 MB (B4), and each voxel
// reads its flow, then gathers 8 corners a channel that depend on it.  The
// first design (one voxel a thread, 64-bit offsets for each of the 8 corners,
// 24 accumulators in B4) took 48 registers for B3 and 72 for B4 and ran at
// 36-41% of the byte bound.  This one keeps a thread's state small and its
// loads many:
// - Trilinear holds one 32-bit offset (corner 0's, which may be negative
//   for a clamped coordinate) and an 8-bit validity mask; corner k's offset
//   is base + (k>>2)*H*W + ((k>>1)&1)*W + (k&1), all int (the wrapper keeps
//   B * max(C, 3) * D * H * W and the cells below 2^31, so int is exact);
// - a thread takes two voxels of one row, x and x + ceil(W/2), decoded
//   from a 32-bit index, so twice the independent gathers are in flight;
//   the two are half a row apart, not neighbours, so that each warp
//   instruction (a flow load, a corner gather, a store) still covers
//   consecutive voxels (with neighbouring pairs (x, x+1) the float atomics
//   of the earlier dsrc touched twice the lines per instruction and ran at
//   1.7x its time); an odd row's second voxel past the end has a zero flow
//   and no corner inside (no loads, no store);
// - B4 walks the corners 7..0 in turn, sums each corner's terms over the
//   channels, and folds them at once into dz, dy, dx (five partial sums in
//   place of 24 accumulators); at C = 1 (the data warp) the cotangent is
//   held in a register, at any other C read again for each corner;
// - loads are templated on their path (Path below).
// Register caps (__launch_bounds__' minimum blocks a SM) were chosen on the
// H100 by device time: 4 blocks (<= 64 registers) for B3 and vecint3d_bwd,
// none for the others; tighter caps made ptxas spill, and the kernels ran
// slower.  ptxas (-Xptxas -v): B3 64, B4 32 (C = 1) / 48, B5 80,
// vecint3d_fwd 64 (48,704 bytes of shared memory), vecint3d_bwd 64
// registers; vecint3d_bwd spills 64 bytes, the others nothing.
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
// - dsrc sums, at each source voxel s, the terms ((g * fx) * fy) * fz of
//   every target voxel that samples s as one of its corners, each term
//   formed in that order.  The sum is bitwise reproducible (see THE BINNED
//   SOURCE GRADIENT below) and within 1e-5 * max(1, max|dsrc|) of autograd
//   of the plain version, which sums in another order; it is bit-equal to
//   ops/warp.py's warp3d_dsrc_binned_plain, which forms the same terms and
//   sums them in the same fixed point.
//
// THE BINNED SOURCE GRADIENT (B5 and the chain backward's dsrc).  The TPU
// kernel is deterministic by construction: it sums each tile's band with a
// selection matmul in the grid's sequential order.  A scatter with float32
// atomics (this port's first design) is not: the order in which the adds
// land changes from run to run, float addition is not associative, and it
// costs 8 atomics a voxel and channel (12.3 M a step of the chain at
// (1,3,80^3)).  Here each source voxel gathers its terms instead:
// 1. count: each target t whose corners are not all outside is counted into
//    its cell, the (D+1, H+1, W+1) grid point of its corner 0 shifted by
//    one on each axis (one int atomicAdd; exact, so order-free), and into
//    its cell's chunk of kChunk cells (one atomicAdd for the lanes of a
//    warp that share the chunk, into one of kCopies copies of the chunk's
//    count, which spreads the warps' adds); max|g| is taken with atomicMax
//    on the float's bits (order-free: the values are non-negative);
// 2. scan: each chunk's cells are scanned into `beg`, the exclusive prefix
//    of the counts, the chunk's own prefix summed from the chunk counts;
// 3. place: each target takes a slot of its cell's list by an atomicSub on
//    its count (any order; the counts end at 0 for the next use) and writes
//    its weights and its corner 0's x there, and its cotangents into the
//    list's channel planes (so the gather reads them in list order, not
//    scattered);
// 4. gather: a warp takes 32 source voxels of a row; for each (dz, dy) the
//    targets that have one of them as corner (dz, dy, dx) are one range of
//    the list (the cells of row (z - dz, y - dy) from x_lo - 1 to x_lo +
//    31), which the lanes walk in turn, coalesced and balanced however the
//    targets crowd; each term, formed for its corner, goes into its voxel's
//    int64 fixed point in shared memory with a shared atomicAdd: the term
//    times 2^e, rounded to an integer (__float2ll_rn); the sum times 2^-e
//    (__ll2float_rn).  Integer addition is associative, so the result is
//    the same bits whatever order the targets were placed and added in.
// The scale: with m = max|g| < 2^E (E from m's exponent field) and at most
// D*H*W <= 2^L terms a voxel, each at most m, e = min(61 - E - L, 100) keeps
// every sum below 2^61; its resolution is 2^(E + L - 61), about 2^-40 of
// max|g| at 80^3.  m = 0 gives e = 100 and an exact 0, with no division; a
// non-finite m (a NaN or inf in g) writes NaN everywhere, so the result is
// never finite where the plain version's is not.  Every phase ends in a
// grid.sync() of one cooperative launch; the counts, offsets and list are
// written and read in that launch, so they are read from L2 (__ldcg).  The
// scratch (`Bins`) is one int32 buffer the wrapper allocates; the entry
// zeroes its counted part (cudaMemsetAsync) and writes every dsrc voxel, so
// dsrc needs no fill.
//
// THE SINGLE WARP (B3, B4, B5).  dflow and dsrc are separate launches, as on
// the TPU: the data warp (source without a gradient) launches dflow alone
// and never bins a dsrc.  src and flow may alias: the kernels only read them
// and write fresh buffers.
//
// B5 ON A SLAB (warp3d_trilinear_bwd_dsrc_slab; the joint model on a volume
// split along D over ranks, where `registered` warps the gathered fake_B
// and fake_B's gradient goes back to its slabs).  Each rank bins its own
// slab's targets over the whole source's cells and gathers every source
// voxel's terms, as B5 does.  Two ranks that each took their own max|g|
// would sum in different units, so the design is the integer one: the
// ranks first all-reduce the bits of max|g| (a max of non-negative floats'
// bits, order-free), each launch takes its fixed point from that and the
// whole source's Ds*H*W voxels -- the whole-volume B5's scale -- and returns
// its int64 sums; the ranks' integers are summed by the gather's
// reduce-scatter, in int64, and only then turned into floats (sum * 2^-e,
// ops/warp.py::from_fixed).  Integer addition is associative, so the
// result is bit-equal to the whole-volume B5's, on every run, whatever the
// number of ranks.  The whole volume keeps its own kernel and entry.
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
// the 50 MB L2.  Both are one cooperative launch (csrc/chain_launch.cuh)
// with a grid capped at the blocks the card holds at once and grid.sync()
// between steps.
//
// THE FORWARD CHAIN.  A step is a field self-warp: each voxel reads its 3
// displacements, then gathers 8 corners x 3 channels that depend on them.
// As gathers through L1/L2 (a thread a voxel pair) a step cost 13.1 us at
// (1,3,80^3), 1.65 of them a grid.sync() (chip_smoke.py --steps on an
// H100).  Here a block takes bricks of kBz x kBy x kBx voxels of one batch
// item (bricks blockIdx.x, + gridDim.x, ..., the same every step; at
// (1,3,80^3) the 500 bricks fit the co-resident grid at once) and, per
// brick and step, stages the brick's box of the field into shared memory:
// the brick and h voxels on each side in z and y (h + 1 past its high
// end), and x from kPadX before the brick to kPadX - 1 past it, all 3
// channels.  When every row of the field starts on 16 bytes (W % 4 == 0
// and aligned buffers, the main path's case) the box is copied with
// 16-byte cp.async.cg copies (L2 only: the field was written by other SMs
// in this launch), else with __ldcg loads, 4 in flight a thread.  Each
// voxel then reads its own displacement and its corners from the box: with
// no test at all when its 8 corners are inside the volume and the box,
// else corner by corner, a corner outside the box (a displacement above
// h) read from L2 (__ldcg) in the same code, so any displacement is
// taken; a box cell outside the volume is never staged and never read
// (the corner's validity mask decides, as in B3).  A warp takes 16 voxels
// of a row and the same 16 two planes on, 16 banks apart, so its corner
// reads meet no bank twice.
// The halo is per brick: the block that stages brick i at step k wrote
// its voxels at step k-1, so it keeps max|v_k| over them (the float's
// bits; the prologue, which scales vec brick by brick, takes max|v_0|) in
// maxes[i] and picks h = min(ceil(max|v_k|), kHalo), a template parameter
// of the step (0, 1, 2), with no exchange between blocks.  The model's own
// field (0.81 voxels at 160^3, about 0.4 at 80^3) is staged whole at every
// step; a field of +-10 voxels sends its far steps' far corners to L2.
// The box at kHalo (13 x 13 x 24 x 3 floats, 48,672 bytes) leaves room for
// 4 blocks a SM at <= 64 registers.  There is one brick a block at the main
// case, so no next brick to copy ahead; all blocks stage at once after the
// sync, then compute.  (Two boxes a block, the next brick's copies in flight
// while this one's voxels are computed, leave room for only 2 blocks a SM, and
// ran slower; so did 4 groups of copies a brick, one for each quarter of its
// voxels, and a first step that stages vec itself in place of a scaling pass
// and its sync, at the +-10-voxel case.)  With a saved stack the forward
// writes v_k into slot k (the backward's input) and v_n into the output; for
// inference the output and one more field alternate (12 MB at 80^3 where the
// stack is 43 MB).  Per voxel the arithmetic is B3's, in the same order, so
// the chain is bit-equal to vecint(..., impl="torch") with and without a
// stack; only where a value is read from changed.
//
// THE BACKWARD CHAIN writes each voxel's own terms of step k, G_{k+1} +
// dflow, into dvec and counts the voxel's cell (phase 1), then scans,
// places and gathers as B5 does, G_k = (G_{k+1} + dflow) + dsrc.  The
// gather of step k and phase 1 of step k-1 are one pass over the gather's
// row segments: the lane that sums a voxel's G_k holds it in its
// registers for that voxel's own terms of step k-1; G_k goes to one of two
// ping-pong fields, which the next placement copies into the list, and
// the last pass writes G_0 * 2^-n into dvec.  Three syncs a step (scan,
// place, the fused pass).  Per voxel the arithmetic is B4's and B5's, so
// the backward is bitwise reproducible.
//
// Coherence.  The L1 caches of the SMs are not coherent with each other;
// they are invalidated between kernel launches.  So every field a chain
// writes and reads in one launch (the forward's v_k, the backward's
// G_{k+1}, own terms and bins) is read from L2 (__ldcg) and stored with
// __stcg; vec and, in the backward, the saved stack (written by an
// earlier launch) take the read-only path (__ldg).  A grid larger than the
// co-resident limit makes the launch fail; the entry returns that error
// and the wrapper raises.

#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chain_launch.cuh"
#include "fixed_point.cuh"

namespace cg = cooperative_groups;

namespace {

// The path of a load: the read-only path (a buffer no thread writes in the
// launch) or L2 alone (a buffer written earlier in the launch; see the
// notes on coherence).
enum class Path { kReadOnly, kL2 };

template <Path kPath>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kPath == Path::kL2) return __ldcg(p);
  return __ldg(p);
}

// One voxel's corners and weights.
struct Trilinear {
  int base;          // corner 0's offset in a (D, H, W) plane (may be < 0)
  int cell;          // corner 0 + (1, 1, 1) in the (D+1, H+1, W+1) cell grid
                     // (meaningful when mask is not 0)
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

// Bit k: corner k = 4*dz + 2*dy + dx is inside, from each axis's two bits
// (bit d: the corner at d along the axis is inside; see inside).
__device__ __forceinline__ unsigned corner_mask(unsigned mz, unsigned my,
                                                unsigned mx) {
  // each axis's bits spread over the corners they govern, then and-ed
  const unsigned z = (mz & 1u) * 0x0fu | (mz >> 1) * 0xf0u;
  const unsigned y = (my & 1u) * 0x33u | (my >> 1) * 0xccu;
  const unsigned x = (mx & 1u) * 0x55u | (mx >> 1) * 0xaau;
  return z & y & x;
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
  t.mask = corner_mask(mz, my, mx);
  t.base = (z0 * H + y0) * W + x0;
  t.cell = ((z0 + 1) * (H + 1) + (y0 + 1)) * (W + 1) + (x0 + 1);
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
// batch's 3 planes, dhw apart), and their Trilinear in a source of Ds
// planes whose plane z0 is the field's plane 0: a slab of a volume split
// along D (B3 and B4 on slabs), the voxel's global plane z + z0 formed in
// int before its conversion to float, so that a slab's corners and
// weights are the whole volume's, bit for bit.
template <Path kPath>
__device__ __forceinline__ void trilinear_pair_in(const float* fb,
                                                  const Pair& q, int dhw,
                                                  int z0, int Ds, int H,
                                                  int W, float2 (&u)[3],
                                                  Trilinear (&t)[2]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = load2<kPath>(fb + a * dhw + q.p, q);
  const int z = q.z + z0;
  t[0] = trilinear(z, q.y, q.x, u[0].x, u[1].x, u[2].x, Ds, H, W);
  t[1] = trilinear(z, q.y, q.x + q.half, u[0].y, u[1].y, u[2].y, Ds, H, W);
}

// The same for a whole volume of D planes (z0 0, Ds D).
template <Path kPath>
__device__ __forceinline__ void trilinear_pair(const float* fb, const Pair& q,
                                               int dhw, int D, int H, int W,
                                               float2 (&u)[3],
                                               Trilinear (&t)[2]) {
  trilinear_pair_in<kPath>(fb, q, dhw, 0, D, H, W, u, t);
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

// ------------------------------------------- the binned source gradient

constexpr int kWarps = kThreads / 32;
constexpr int kScanPer = 8;                       // cells a thread scans
constexpr int kChunk = kThreads * kScanPer;       // cells a chunk
// copies of each chunk's count, a warp adding to copy (its index mod
// kCopies): thousands of warps' adds to one count in L2 serialise
constexpr int kCopies = 16;

// The scratch of the binned gradient, carved from one int32 buffer (see
// bins_layout): the part up to `beg` is zeroed by the entry.
struct Bins {
  unsigned* gmax;   // a slot a step: the bits of max|g|
  int* csum;        // a row of nchunks x kCopies chunk counts a step
  int* cnt;         // nchunks * kChunk cell counts (0 again after placing)
  int* beg;         // nchunks * kChunk: the exclusive scan of cnt
  float* list;      // cap entries of es floats: wz, wy, wx, the bits of
                    // corner 0's x, then the target's C cotangents
  int es;           // 4 + C rounded up to 4: an entry is whole float4s
  int cap;          // B * D * H * W, the most targets
  int nc;           // cells a batch item, (D+1)(H+1)(W+1)
  int nchunks;      // chunks of all B * nc cells and one past the end
};

long long round8(long long n) { return (n + 7) / 8 * 8; }

// The buffer's layout for B volumes of (D, H, W), C channels and nsteps
// steps: fills `bins` when `base` is given; returns the ints the buffer
// holds, and in `zeroed` those the entry zeroes.  Every part starts on 32
// bytes.  Ds > 0: the targets are a slab of D planes of a source of Ds
// (B5 on a slab), whose cells the bins cover.
long long bins_layout(int* base, int B, int C, int D, int H, int W,
                      int nsteps, Bins* bins, long long* zeroed,
                      int Ds = 0) {
  const long long nc = (long long)((Ds > 0 ? Ds : D) + 1) * (H + 1) * (W + 1);
  const long long nchunks = (B * nc + 1 + kChunk - 1) / kChunk;
  const long long gmax = round8(nsteps);
  const long long csum = round8(nsteps * nchunks * kCopies);
  const long long cells = nchunks * kChunk, cap = (long long)B * D * H * W;
  const int es = 4 + (C + 3) / 4 * 4;
  *zeroed = gmax + csum + cells;
  if (base != nullptr) {
    bins->gmax = reinterpret_cast<unsigned*>(base);
    bins->csum = base + gmax;
    bins->cnt = bins->csum + csum;
    bins->beg = bins->cnt + cells;
    bins->list = reinterpret_cast<float*>(bins->beg + cells);
    bins->es = es;
    bins->cap = (int)cap;
    bins->nc = (int)nc;
    bins->nchunks = (int)nchunks;
  }
  return *zeroed + cells + es * cap;
}

// The block's max of m into *slot: one atomicMax a block.  Every thread of
// the block calls it.
__device__ __forceinline__ void max_into(unsigned* slot, unsigned m,
                                         unsigned* sh) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = max(m, sh[w]);
    atomicMax(slot, m);
  }
  __syncthreads();
}

// The sum of v over the block, in every thread.  Every thread calls it.
__device__ __forceinline__ int block_sum(int v, int* sh) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += sh[w];
  __syncthreads();
  return total;
}

// The sum of v over the block's threads before this one.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += sh[w];
  __syncthreads();
  return before + inc - v;
}

// Phase 1: count target t of batch item b into its cell and its chunk (a
// warp's lanes that share a chunk add once).  Every lane of the warp that
// is in the loop calls it.
__device__ __forceinline__ void count_target(const Bins& bins, int* csum,
                                             int b, const Trilinear& t) {
  const bool binned = t.mask != 0;
  const int bc = b * bins.nc + t.cell;
  if (binned) atomicAdd(bins.cnt + bc, 1);
  const int chunk = binned ? bc / kChunk : -1;
  const unsigned peers = __match_any_sync(__activemask(), chunk);
  if (binned && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    const int copy = (blockIdx.x * kWarps + (threadIdx.x >> 5)) % kCopies;
    atomicAdd(csum + chunk * kCopies + copy, __popc(peers));
  }
}

// Phase 2: `beg`, the exclusive scan of the counts, chunk by chunk, from
// the chunk counts `csum`.  Every thread of the block calls it.
__device__ void scan_cells(const Bins& bins, const int* csum, int* sh) {
  for (int j = blockIdx.x; j < bins.nchunks; j += gridDim.x) {
    int part = 0;
    for (int i = threadIdx.x; i < j * kCopies; i += kThreads) {
      part += __ldcg(csum + i);
    }
    const int prefix = block_sum(part, sh);
    const int base = j * kChunk + threadIdx.x * kScanPer;
    const int4 a = __ldcg(reinterpret_cast<const int4*>(bins.cnt + base));
    const int4 c = __ldcg(reinterpret_cast<const int4*>(bins.cnt + base + 4));
    const int n[kScanPer] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    int ex[kScanPer], run = 0;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i) {
      ex[i] = run;
      run += n[i];
    }
    const int off = prefix + block_exclusive_scan(run, sh);
    int4* out = reinterpret_cast<int4*>(bins.beg + base);
    __stcg(out, make_int4(off + ex[0], off + ex[1], off + ex[2], off + ex[3]));
    __stcg(out + 1,
           make_int4(off + ex[4], off + ex[5], off + ex[6], off + ex[7]));
  }
}

// Phase 3 for pair q (of batch item b; fb its flow, gb its C cotangent
// planes, D planes each): each target takes a slot of its cell's list and
// writes its entry there, whole float4s (one 32-byte sector for C <= 4).
// The targets sample a source of Ds planes from plane z0 (a whole volume:
// 0 and D).
template <Path kPath>
__device__ __forceinline__ void place_pair(const Bins& bins, const float* fb,
                                          const float* gb, int C,
                                          const Pair& q, int D, int H,
                                          int W, int z0, int Ds) {
  const int dhw = D * H * W;
  float2 u[3];
  Trilinear t[2];
  trilinear_pair_in<Path::kReadOnly>(fb, q, dhw, z0, Ds, H, W, u, t);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!t[i].mask) continue;
    const int bc = q.b * bins.nc + t[i].cell;
    const int pos = __ldcg(bins.beg + bc) + atomicSub(bins.cnt + bc, 1) - 1;
    const int x0 = t[i].cell % (W + 1) - 1;
    float4* e = reinterpret_cast<float4*>(bins.list + (long long)pos * bins.es);
    __stcg(e, make_float4(t[i].wz, t[i].wy, t[i].wx, __int_as_float(x0)));
    const float* gp = gb + q.p + i * q.half;
    for (int c = 0; c < C; c += 4) {
      float v[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        v[a] = c + a < C ? ld<kPath>(gp + (c + a) * dhw) : 0.0f;
      }
      __stcg(++e, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

// The gather's unit of work, a warp's: 32 voxels x_lo .. x_lo + 31 of row
// (b, z, y), lane l's voxel x = x_lo + l (inside when x < W).
struct Row {
  int b, z, y, x;
  bool in;
};

__device__ __forceinline__ Row row_at(int w, int D, int H, int W) {
  const int nxb = (W + 31) >> 5;
  Row r;
  int rest = w / nxb;
  r.x = (w - rest * nxb) * 32 + (threadIdx.x & 31);
  r.y = rest % H;
  rest /= H;
  r.z = rest % D;
  r.b = rest / D;
  r.in = r.x < W;
  return r;
}

// A warp's int64 sums in shared memory, kept as two 32-bit halves so that
// every add is a native 32-bit shared atomic (a 64-bit one is a
// compare-and-swap loop): lo takes the low half and hands its carry to hi,
// so (hi, lo) is the exact sum mod 2^64 in any order.
struct Acc {
  unsigned lo[3][32];
  unsigned hi[3][32];
};

__device__ __forceinline__ void acc_add(Acc& a, int c, int s, long long v) {
  const unsigned l = (unsigned)v;
  const unsigned old = atomicAdd(&a.lo[c][s], l);
  atomicAdd(&a.hi[c][s], (unsigned)(v >> 32) + (old + l < old ? 1u : 0u));
}

__device__ __forceinline__ long long acc_at(const Acc& a, int c, int s) {
  return (long long)(((unsigned long long)a.hi[c][s] << 32) | a.lo[c][s]);
}

// One entry's terms for its corners (dz, dy, 0) and (dz, dy, 1) that are
// voxels of the warp's segment (x_lo .. x_lo + 31, inside the row), into
// their sums.
template <int kC>
__device__ __forceinline__ void add_terms(Acc& acc, const float4& e,
                                          const float (&gc)[kC], int dz,
                                          int dy, int x_lo, int W,
                                          const Fixed& f) {
  const float fz = weight(e.x, dz), fy = weight(e.y, dy);
  const int x0 = __float_as_int(e.w);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int s = x0 + dx - x_lo;
    if (s < 0 || s >= 32 || x0 + dx >= W) continue;
    const float fx = weight(e.z, dx);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float term = __fmul_rn(__fmul_rn(__fmul_rn(gc[c], fx), fy), fz);
      acc_add(acc, c, s, __float2ll_rn(__fmul_rn(term, f.scale)));
    }
  }
}

// Phase 4 for the warp's row segment r, kC channels from channel c0:
// out[c] = lane's voxel's sum of the terms of every target that has it as a
// corner, an integer in the fixed point f (gather_row: its value).  For each (dz, dy) the targets whose corner
// 0 lies in row (z - dz, y - dy) at x_lo - 1 .. x_lo + 31 are one range of
// the list; the lanes walk the 4 ranges as one sequence, two entries a lane
// at a time (coalesced, and balanced however the targets crowd), and add
// each term to its voxel's sum in shared memory (`acc`, the warp's),
// order-free.  The whole warp calls it.
template <int kC>
__device__ __forceinline__ void gather_sums(const Bins& bins, int c0,
                                            const Row& r, int H, int W,
                                            const Fixed& f, Acc& acc,
                                            long long (&out)[kC]) {
  const int lane = threadIdx.x & 31, x_lo = r.x - lane;
#pragma unroll
  for (int c = 0; c < kC; ++c) acc.lo[c][lane] = acc.hi[c][lane] = 0;
  int lo[4], n[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = r.b * bins.nc +
                    ((r.z - (q >> 1) + 1) * (H + 1) + (r.y - (q & 1) + 1)) *
                        (W + 1);
    lo[q] = __ldcg(bins.beg + row + x_lo);
    n[q] = __ldcg(bins.beg + row + min(x_lo + 32, W) + 1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) n[q] -= lo[q];
  const int total = n[0] + n[1] + n[2] + n[3];
  __syncwarp();
  // entry j of the sequence: its range q and its place in the list
  auto at = [&](int j, int& q) {
    int base = lo[0];
    q = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {   // constant indices: n, lo stay registers
      if (q == k && j >= n[k]) {
        j -= n[k];
        q = k + 1;
        base = lo[k + 1];
      }
    }
    return base + j;
  };
  auto load = [&](int i, float4& e, float (&gc)[kC]) {
    const float* ep = bins.list + (long long)i * bins.es;
    e = __ldcg(reinterpret_cast<const float4*>(ep));
#pragma unroll
    for (int c = 0; c < kC; ++c) gc[c] = __ldcg(ep + 4 + c0 + c);
  };
  for (int j = lane; j < total; j += 64) {
    const bool two = j + 32 < total;
    int q0, q1 = 0;
    float4 e0, e1;
    float g0[kC], g1[kC];
    load(at(j, q0), e0, g0);
    if (two) load(at(j + 32, q1), e1, g1);
    add_terms(acc, e0, g0, q0 >> 1, q0 & 1, x_lo, W, f);
    if (two) add_terms(acc, e1, g1, q1 >> 1, q1 & 1, x_lo, W, f);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kC; ++c) out[c] = acc_at(acc, c, lane);
  __syncwarp();
}

template <int kC>
__device__ __forceinline__ void gather_row(const Bins& bins, int c0,
                                           const Row& r, int H, int W,
                                           const Fixed& f, Acc& acc,
                                           float (&out)[kC]) {
  long long sums[kC];
  gather_sums<kC>(bins, c0, r, H, W, f, acc, sums);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    out[c] = f.finite ? __fmul_rn(__ll2float_rn(sums[c]), f.inv)
                      : __int_as_float(0x7fffffff);
  }
}

// ------------------------------------------------------- the single warp

// B3 and B4 take the output's (and the flow's) D planes and the source's
// Ds, the output's plane 0 being the source's plane z0: a whole volume
// with z0 0 and Ds D, or a slab of one split along D over ranks (the
// source then the whole volume, gathered).
__global__ void __launch_bounds__(kThreads, 4)
    warp3d_trilinear_fwd(const float* __restrict__ src,
                         const float* __restrict__ flow,
                         float* __restrict__ out, int npairs, int C, int D,
                         int H, int W, int Ds, int z0) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= npairs) return;
  const Pair q = pair_at(j, D, H, W);
  const int hw = H * W, dhw = D * hw, shw = Ds * hw;
  float2 u[3];
  Trilinear t[2];
  trilinear_pair_in<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw, z0, Ds, H,
                                     W, u, t);
  for (int c = 0; c < C; ++c) {
    const int plane = (q.b * C + c) * dhw;
    const float* sp = src + (q.b * C + c) * shw;
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
// own.  kSlab: the output is a slab (Ds and z0 read); a whole volume
// compiles without them, as before slabs came: with them B4 at C = 1 took
// 40 registers in place of 32 and 59.3 us in place of 53.1-53.6 at the
// 160^3 data warp (the same card and phase).
template <bool kOne, bool kSlab>
__global__ void __launch_bounds__(kThreads)
    warp3d_trilinear_bwd_dflow(const float* __restrict__ src,
                               const float* __restrict__ flow,
                               const float* __restrict__ g,
                               float* __restrict__ dflow, int npairs, int C,
                               int D, int H, int W, int Ds, int z0) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= npairs) return;
  const Pair q = pair_at(j, D, H, W);
  const int hw = H * W, dhw = D * hw, shw = kSlab ? Ds * hw : dhw;
  const int nc = kOne ? 1 : C;
  float2 u[3];
  Trilinear t[2];
  trilinear_pair_in<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw,
                                     kSlab ? z0 : 0, kSlab ? Ds : D, H, W, u,
                                     t);
  const float* sb = src + q.b * nc * shw;
  const float* gb = g + q.b * nc * dhw + q.p;
  float3 d0, d1;
  if constexpr (kOne) {
    const float2 gv = load2<Path::kReadOnly>(gb, q);
    d0 = dflow_at(sb, 1, shw, hw, W, t[0], [&](int) { return gv.x; });
    d1 = dflow_at(sb, 1, shw, hw, W, t[1], [&](int) { return gv.y; });
  } else {
    const int half = q.half;
    const bool two = q.two;
    d0 = dflow_at(sb, nc, shw, hw, W, t[0],
                  [&](int c) { return __ldg(gb + c * dhw); });
    d1 = dflow_at(sb, nc, shw, hw, W, t[1], [&](int c) {
      return two ? __ldg(gb + c * dhw + half) : 0.0f;
    });
  }
  float* db = dflow + q.b * 3 * dhw + q.p;
  store2<false>(db, make_float2(d0.x, d1.x), q);
  store2<false>(db + dhw, make_float2(d0.y, d1.y), q);
  store2<false>(db + 2 * dhw, make_float2(d0.z, d1.z), q);
}

// Phases first..last of the binned gradient (0 count, 1 scan, 2 place, 3
// gather), a grid.sync() between two: the entry's cooperative launch runs
// 0..3 (the phases as 4 plain launches are a yardstick,
// csrc/yardsticks/dsrc3d.cu).  The gather sums 3 channels at a time while
// 3 are left, then one.
__global__ void __launch_bounds__(kThreads)
    warp3d_trilinear_bwd_dsrc(const float* __restrict__ flow,
                              const float* __restrict__ g,
                              float* __restrict__ dsrc, Bins bins, int npairs,
                              int C, int D, int H, int W, int first,
                              int last) {
  __shared__ int sh[kWarps];
  __shared__ Acc acc[kWarps];
  const int dhw = D * H * W;
  const int lead = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  for (int phase = first; phase <= last; ++phase) {
    if (phase > first) cg::this_grid().sync();
    if (phase == 0) {
      unsigned m = 0;
      for (int j = lead; j < npairs; j += stride) {
        const Pair q = pair_at(j, D, H, W);
        float2 u[3];
        Trilinear t[2];
        trilinear_pair<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw, D, H,
                                        W, u, t);
        count_target(bins, bins.csum, q.b, t[0]);
        count_target(bins, bins.csum, q.b, t[1]);
        for (int c = 0; c < C; ++c) {
          const float2 gv =
              load2<Path::kReadOnly>(g + (q.b * C + c) * dhw + q.p, q);
          m = max(m, max(abs_bits(gv.x), abs_bits(gv.y)));
        }
      }
      max_into(bins.gmax, m, reinterpret_cast<unsigned*>(sh));
    } else if (phase == 1) {
      scan_cells(bins, bins.csum, sh);
    } else if (phase == 2) {
      for (int j = lead; j < npairs; j += stride) {
        const Pair q = pair_at(j, D, H, W);
        place_pair<Path::kReadOnly>(bins, flow + q.b * 3 * dhw,
                                    g + q.b * C * dhw, C, q, D, H, W, 0, D);
      }
    } else {
      const Fixed f = fixed_of(__ldcg(bins.gmax), dhw);
      const int ntasks = npairs / ((W + 1) >> 1) * ((W + 31) >> 5);
      Acc& wacc = acc[threadIdx.x >> 5];
      for (int w = lead >> 5; w < ntasks; w += stride >> 5) {
        const Row r = row_at(w, D, H, W);
        float* out = dsrc + r.b * C * dhw + (r.z * H + r.y) * W + r.x;
        int c = 0;
        for (; c + 3 <= C; c += 3) {
          float v[3];
          gather_row<3>(bins, c, r, H, W, f, wacc, v);
          if (r.in) {
#pragma unroll
            for (int a = 0; a < 3; ++a) out[(c + a) * dhw] = v[a];
          }
        }
        for (; c < C; ++c) {
          float v[1];
          gather_row<1>(bins, c, r, H, W, f, wacc, v);
          if (r.in) out[c * dhw] = v[0];
        }
      }
    }
  }
}

// B5 on a slab: the targets are the D planes of flow and g (a slab of a
// volume split along D), sampling a source of Ds planes from plane z0; the
// bins cover the whole source's cells, and sums (B,C,Ds,H,W) receives
// every source voxel's int64 sum of this slab's terms, in the fixed point
// of *bins.gmax, which the entry sets to max|g| over the whole volume's
// cotangent (every rank's, the same bits on every rank) with e from its
// Ds*H*W voxels: the whole-volume B5's scale.  The ranks' sums then add up,
// exactly, to the whole-volume B5's integers.  The phases as there, with no
// max taken.
__global__ void __launch_bounds__(kThreads)
    warp3d_trilinear_bwd_dsrc_slab(const float* __restrict__ flow,
                                   const float* __restrict__ g,
                                   long long* __restrict__ sums, Bins bins,
                                   int npairs, int C, int D, int H, int W,
                                   int Ds, int z0) {
  __shared__ int sh[kWarps];
  __shared__ Acc acc[kWarps];
  const int dhw = D * H * W, sdhw = Ds * H * W;
  const int lead = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  cg::grid_group grid = cg::this_grid();
  for (int j = lead; j < npairs; j += stride) {
    const Pair q = pair_at(j, D, H, W);
    float2 u[3];
    Trilinear t[2];
    trilinear_pair_in<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw, z0, Ds,
                                       H, W, u, t);
    count_target(bins, bins.csum, q.b, t[0]);
    count_target(bins, bins.csum, q.b, t[1]);
  }
  grid.sync();
  scan_cells(bins, bins.csum, sh);
  grid.sync();
  for (int j = lead; j < npairs; j += stride) {
    const Pair q = pair_at(j, D, H, W);
    place_pair<Path::kReadOnly>(bins, flow + q.b * 3 * dhw,
                                g + q.b * C * dhw, C, q, D, H, W, z0, Ds);
  }
  grid.sync();
  const Fixed f = fixed_of(__ldcg(bins.gmax), sdhw);
  const int B = npairs / (D * H * ((W + 1) >> 1));
  const int ntasks = B * Ds * H * ((W + 31) >> 5);
  Acc& wacc = acc[threadIdx.x >> 5];
  for (int w = lead >> 5; w < ntasks; w += stride >> 5) {
    const Row r = row_at(w, Ds, H, W);
    long long* out = sums + (long long)r.b * C * sdhw +
                     (r.z * H + r.y) * W + r.x;
    int c = 0;
    for (; c + 3 <= C; c += 3) {
      long long v[3];
      gather_sums<3>(bins, c, r, H, W, f, wacc, v);
      if (r.in) {
#pragma unroll
        for (int a = 0; a < 3; ++a) out[(long long)(c + a) * sdhw] = v[a];
      }
    }
    for (; c < C; ++c) {
      long long v[1];
      gather_sums<1>(bins, c, r, H, W, f, wacc, v);
      if (r.in) out[(long long)c * sdhw] = v[0];
    }
  }
}

// ----------------------------------------------------------- the chain

// The forward chain's bricks: a block computes kBz x kBy x kBx voxels of
// one batch item at a time from a box of the field staged in shared
// memory: the brick and h <= kHalo voxels around it in z and y (h + 1 past
// its high end), x from kPadX before the brick to kPadX - 1 past it (whole
// 16-byte chunks, room for a halo of up to kPadX - 1), all 3 channels:
// 13 x 13 x 24 x 3 floats, 48,672 bytes, at kHalo.
constexpr int kBz = 8, kBy = 8, kBx = 16;
constexpr int kHalo = 2;
constexpr int kPadX = 4;
constexpr int kBoxX = kBx + 2 * kPadX;
constexpr int kBoxMax = (kBz + 2 * kHalo + 1) * (kBy + 2 * kHalo + 1) * kBoxX;
static_assert(kHalo < kPadX && kBx % 4 == 0, "x halo in whole chunks");
static_assert(kBz * kBy * kBx % kThreads == 0, "whole voxels a thread");

// Where v_k lives: with a saved stack, slot k of `steps` for k < n and
// `out` for k = n; without one, `out` and the single field `steps`
// alternate so that v_n lands in `out`.
__device__ __forceinline__ float* field3(float* steps, long long slot,
                                         float* out, int k, int n,
                                         bool save) {
  if (save) return k == n ? out : steps + k * slot;
  return ((n - k) & 1) ? steps : out;
}

// The max of m over the block, in every thread.  Every thread calls it.
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* sh) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = max(m, sh[w]);
  __syncthreads();
  return m;
}

// The halo a brick stages when max|v| over its voxels has the bits
// `mbits`: ceil(max|v|), at most kHalo (a NaN or inf: kHalo).  Each
// displacement is then at most h, so each corner of a voxel z lies in
// z - h .. z + h + 1 (z + u rounds monotonically and z +- h is exact).
__device__ __forceinline__ int halo_of(unsigned mbits) {
  if (mbits >= 0x7f800000u) return kHalo;
  const float m = __uint_as_float(mbits);
  return m >= (float)kHalo ? kHalo : (int)ceilf(m);
}

// 16 bytes from global memory (through L2 alone) into shared memory,
// asynchronously; copies_done waits for all of the thread's copies.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A brick of the chain: batch item b, the box's origin (oz, oy, ox).
struct Brick {
  int b, oz, oy, ox;
};

__device__ __forceinline__ Brick brick_at(int i, int D, int H, int W, int h) {
  const int nbz = (D + kBz - 1) / kBz, nby = (H + kBy - 1) / kBy,
            nbx = (W + kBx - 1) / kBx;
  Brick k;
  const int bx = i % nbx;
  i /= nbx;
  const int by = i % nby;
  i /= nby;
  k.oz = (i % nbz) * kBz - h;
  k.oy = by * kBy - h;
  k.ox = bx * kBx - kPadX;
  k.b = i / nbz;
  return k;
}

// Voxel j of a brick whose box has the halo kH: its place (z, y, x) in
// the volume and its cell in the box.  A warp takes 16 voxels of a row
// and the 16 of the same row two planes on: two planes of the box are 16
// banks apart at every halo (2 * 9, 11, 13 rows of 24 floats), so the
// warp's reads of a smooth field's corners meet no bank twice.
template <int kH>
__device__ __forceinline__ void voxel_of(int j, const Brick& k, int& z,
                                         int& y, int& x, int& cell) {
  static_assert(kBx == 16 && kBy == 8 && kBz == 8, "the lanes' layout");
  const int lx = j & 15, w = j >> 5, ly = w & 7, pair = w >> 3;
  const int lz = (pair & 1) + ((pair >> 1) << 2) + ((j >> 4) & 1) * 2;
  z = k.oz + kH + lz;
  y = k.oy + kH + ly;
  x = k.ox + kPadX + lx;
  cell = ((lz + kH) * (kBy + 2 * kH + 1) + (ly + kH)) * kBoxX + lx + kPadX;
}

// Stage brick k's box of the field vb (the batch item's 3 planes) into
// `box`: with 16-byte asynchronous copies when every row of the field
// starts on 16 bytes (`aligned`), else with scalar loads, 4 in flight a
// thread.  Cells outside the volume are not written.  Every thread of the
// block calls it.
template <int kH>
__device__ __forceinline__ void stage(const float* vb, const Brick& k,
                                      bool aligned, int D, int H, int W,
                                      float* box) {
  constexpr int SZ = kBz + 2 * kH + 1, SY = kBy + 2 * kH + 1,
                ROW = kBoxX / 4, N4 = SZ * SY * ROW, CELLS = SZ * SY * kBoxX;
  const int dhw = D * H * W;
  for (int i = threadIdx.x; i < 3 * N4; i += kThreads) {
    const int a = i / N4;
    int r = i - a * N4;
    const int z = r / (SY * ROW);
    r -= z * (SY * ROW);
    const int y = r / ROW, c = r - y * ROW;
    const int gz = k.oz + z, gy = k.oy + y, gx = k.ox + 4 * c;
    if (gz < 0 || gz >= D || gy < 0 || gy >= H) continue;
    float* dst = box + a * CELLS + (z * SY + y) * kBoxX + 4 * c;
    const float* src = vb + a * dhw + (gz * H + gy) * W + gx;
    if (aligned) {
      if (gx >= 0 && gx < W) copy16(dst, src);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = gx + e >= 0 && gx + e < W ? __ldcg(src + e) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = v[e];
    }
  }
  if (aligned) copies_done();
  __syncthreads();
}

// How a voxel's corners are read: every corner inside the volume and the
// box (kFull: no test), every corner inside the volume in the box
// (kStaged), or each as it lies (kAny: outside the box from L2).
enum class Corners3 { kFull, kStaged, kAny };

// B3's blend of channel a at one voxel, each corner inside the volume
// (mask) read from the box at s0 or, when not staged, from L2 at g0 of the
// channel's plane gp.
template <int kH, Corners3 kHow>
__device__ __forceinline__ float blend_box(const float* box, int s0,
                                           const float* gp, int g0,
                                           unsigned mask, unsigned staged,
                                           float wz, float wy, float wx,
                                           int hw, int W) {
  constexpr int SY = kBy + 2 * kH + 1;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const float* sp = box + s0 + (dz * SY + dy) * kBoxX + dx;
    float val;
    if constexpr (kHow == Corners3::kFull) {
      val = *sp;
    } else if ((mask >> k) & 1u) {
      val = kHow == Corners3::kStaged || ((staged >> k) & 1u)
                ? *sp
                : __ldcg(gp + g0 + corner(k, hw, W));
    } else {
      val = 0.0f;
    }
    const float term = __fmul_rn(
        __fmul_rn(__fmul_rn(val, weight(wz, dz)), weight(wy, dy)),
        weight(wx, dx));
    acc = k == 0 ? term : __fadd_rn(acc, term);
  }
  return acc;
}

// One step of the forward chain at brick k with a halo of kH: v -> next
// at the brick's voxels; returns max|next| over them (bits), in every
// thread.  Every thread of the block calls it.
template <int kH>
__device__ unsigned step_brick(const float* v, float* next, bool last,
                               bool aligned, int i, int D, int H, int W,
                               float* box, unsigned* sh) {
  constexpr int SZ = kBz + 2 * kH + 1, SY = kBy + 2 * kH + 1,
                CELLS = SZ * SY * kBoxX;
  const int hw = H * W, dhw = D * hw;
  const Brick k = brick_at(i, D, H, W, kH);
  const float* vb = v + k.b * 3 * dhw;
  stage<kH>(vb, k, aligned, D, H, W, box);
  unsigned m = 0;
#pragma unroll 1
  for (int j = threadIdx.x; j < kBz * kBy * kBx; j += kThreads) {
    int z, y, x, c;
    voxel_of<kH>(j, k, z, y, x, c);
    if (z >= D || y >= H || x >= W) continue;
    const float u[3] = {box[c], box[CELLS + c], box[2 * CELLS + c]};
    const float zs = clamp_coord((float)z + u[0], D);
    const float ys = clamp_coord((float)y + u[1], H);
    const float xs = clamp_coord((float)x + u[2], W);
    const float z0f = floorf(zs), y0f = floorf(ys), x0f = floorf(xs);
    const int z0 = (int)z0f, y0 = (int)y0f, x0 = (int)x0f;
    const float wz = zs - z0f, wy = ys - y0f, wx = xs - x0f;
    // corner k: inside the volume (mask), inside the box (staged)
    const unsigned mask = corner_mask(inside(z0, D), inside(y0, H),
                                      inside(x0, W));
    const unsigned staged = corner_mask(inside(z0 - k.oz, SZ),
                                        inside(y0 - k.oy, SY),
                                        inside(x0 - k.ox, kBoxX));
    const int g0 = (z0 * H + y0) * W + x0;
    const int s0 = ((z0 - k.oz) * SY + (y0 - k.oy)) * kBoxX + (x0 - k.ox);
    float* nb = next + k.b * 3 * dhw + (z * H + y) * W + x;
    float acc[3];
    if ((mask & staged) == 0xffu) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] = blend_box<kH, Corners3::kFull>(box + a * CELLS, s0, vb, g0,
                                                mask, staged, wz, wy, wx, hw,
                                                W);
      }
    } else if ((mask & ~staged) == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] = blend_box<kH, Corners3::kStaged>(box + a * CELLS, s0, vb,
                                                  g0, mask, staged, wz, wy,
                                                  wx, hw, W);
      }
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[a] = blend_box<kH, Corners3::kAny>(box + a * CELLS, s0,
                                               vb + a * dhw, g0, mask,
                                               staged, wz, wy, wx, hw, W);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float out = __fadd_rn(u[a], acc[a]);
      if (last) {
        nb[a * dhw] = out;
      } else {
        __stcg(nb + a * dhw, out);
      }
      m = max(m, abs_bits(out));
    }
  }
  return block_max(m, sh);
}

// The forward chain.  A block takes bricks blockIdx.x, + gridDim.x, ...,
// the same every step, so the block that stages a brick at step k wrote
// its voxels at step k-1: it keeps max|v_k| over them in maxes[brick]
// (written and read by its thread 0) and picks the brick's halo from it,
// with no exchange between blocks.
__global__ void __launch_bounds__(kThreads, 4)
    vecint3d_fwd(const float* __restrict__ vec, float* steps, long long slot,
                 float* out, unsigned* maxes, int B, int D, int H, int W,
                 int nsteps, int save, int aligned, float scale) {
  __shared__ __align__(16) float box[3 * kBoxMax];
  __shared__ unsigned sh[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int hw = H * W, dhw = D * hw;
  const int nbricks = B * ((D + kBz - 1) / kBz) * ((H + kBy - 1) / kBy) *
                      ((W + kBx - 1) / kBx);

  // v_0 = vec * 2^-n, brick by brick
  float* v0 = field3(steps, slot, out, 0, nsteps, save);
  for (int i = blockIdx.x; i < nbricks; i += gridDim.x) {
    const Brick k = brick_at(i, D, H, W, 0);
    unsigned m = 0;
    for (int j = threadIdx.x; j < kBz * kBy * kBx; j += kThreads) {
      int z, y, x, c;
      voxel_of<0>(j, k, z, y, x, c);
      if (z >= D || y >= H || x >= W) continue;
      const int o = k.b * 3 * dhw + (z * H + y) * W + x;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float val = __fmul_rn(__ldg(vec + o + a * dhw), scale);
        __stcg(v0 + o + a * dhw, val);
        m = max(m, abs_bits(val));
      }
    }
    m = block_max(m, sh);
    if (threadIdx.x == 0 && nsteps > 0) maxes[i] = m;
  }
  for (int step = 0; step < nsteps; ++step) {
    grid.sync();
    const float* v = field3(steps, slot, out, step, nsteps, save);
    float* next = field3(steps, slot, out, step + 1, nsteps, save);
    const bool last = step + 1 == nsteps;
    for (int i = blockIdx.x; i < nbricks; i += gridDim.x) {
      // maxes[i] was written by this block's thread 0 before the sync; the
      // last brick's reads of the box ended in its block_max
      const int h = halo_of(maxes[i]);
      unsigned m;
      if (h == 0) {
        m = step_brick<0>(v, next, last, aligned, i, D, H, W, box, sh);
      } else if (h == 1) {
        m = step_brick<1>(v, next, last, aligned, i, D, H, W, box, sh);
      } else {
        m = step_brick<kHalo>(v, next, last, aligned, i, D, H, W, box, sh);
      }
      if (threadIdx.x == 0) maxes[i] = m;
    }
  }
}

// Phase 1 of a step at lane's voxel of row r (offset p in its plane): the
// own terms G + dflow (G its cotangents; v the step's field) into `own`,
// the voxel counted into its cell (csum the step's chunk counts), and m the
// running max of |G|'s bits.  The whole warp calls it.
__device__ __forceinline__ void own_terms(const float* v, const Row& r,
                                          int p, const float (&G)[3],
                                          float* own, const Bins& bins,
                                          int* csum, unsigned& m, int D,
                                          int H, int W) {
  const int hw = H * W, dhw = D * hw;
  const float* vb = v + r.b * 3 * dhw;
  Trilinear t;
  t.mask = 0;
  t.cell = 0;
  if (r.in) {
    t = trilinear(r.z, r.y, r.x, __ldg(vb + p), __ldg(vb + dhw + p),
                  __ldg(vb + 2 * dhw + p), D, H, W);
    const float3 d = dflow_at(vb, 3, dhw, hw, W, t,
                              [&](int c) { return G[c]; });
    float* ob = own + r.b * 3 * dhw + p;
    __stcg(ob, __fadd_rn(G[0], d.x));
    __stcg(ob + dhw, __fadd_rn(G[1], d.y));
    __stcg(ob + 2 * dhw, __fadd_rn(G[2], d.z));
  }
  count_target(bins, csum, r.b, t);
#pragma unroll
  for (int a = 0; a < 3; ++a) m = max(m, abs_bits(G[a]));
}

// G_n is g.  Step k's own terms are in dvec; its G_{k+1} is g or one of the
// two ping-pong fields of `scratch` (nval floats apart), G_k goes to the
// other; the last pass writes G_0 * scale into dvec.  Phases 1 and 4 run
// over the gather's row segments, a warp each; 3 over voxel pairs.  Capped
// at 64 registers (4 blocks a SM), chosen on the H100 by device time: with
// 108 registers and 2 blocks a SM too few warps hide the gathers' latency.
__global__ void __launch_bounds__(kThreads, 4)
    vecint3d_bwd(const float* __restrict__ steps, long long slot,
                 const float* __restrict__ g, float* scratch, Bins bins,
                 float* dvec, int npairs, int B, int D, int H, int W,
                 int nsteps, float scale) {
  __shared__ int sh[kWarps];
  __shared__ Acc acc[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int dhw = D * H * W;
  const long long nval = 3LL * B * dhw;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int ntasks = npairs / ((W + 1) >> 1) * ((W + 31) >> 5);
  unsigned* shm = reinterpret_cast<unsigned*>(sh);
  Acc& wacc = acc[threadIdx.x >> 5];

  if (nsteps == 0) {
    for (long long j = first; j < nval; j += stride) dvec[j] = g[j];
    return;
  }
  // phase 1 of step n-1
  unsigned m = 0;
  for (int w = first >> 5; w < ntasks; w += stride >> 5) {
    const Row r = row_at(w, D, H, W);
    const int p = (r.z * H + r.y) * W + r.x;
    float G[3] = {0.0f, 0.0f, 0.0f};
    if (r.in) {
#pragma unroll
      for (int a = 0; a < 3; ++a) G[a] = __ldcg(g + (r.b * 3 + a) * dhw + p);
    }
    own_terms(steps + (nsteps - 1) * slot, r, p, G, dvec, bins,
              bins.csum + (nsteps - 1) * bins.nchunks * kCopies, m, D, H,
              W);
  }
  max_into(bins.gmax + nsteps - 1, m, shm);
  for (int k = nsteps - 1; k >= 0; --k) {
    const float* v = steps + k * slot;
    const float* gin = k + 1 == nsteps ? g : scratch + ((k + 1) & 1) * nval;
    float* gout = k > 0 ? scratch + (k & 1) * nval : nullptr;
    grid.sync();
    scan_cells(bins, bins.csum + k * bins.nchunks * kCopies, sh);
    grid.sync();
    for (int j = first; j < npairs; j += stride) {
      const Pair q = pair_at(j, D, H, W);
      place_pair<Path::kL2>(bins, v + q.b * 3 * dhw, gin + q.b * 3 * dhw, 3,
                            q, D, H, W, 0, D);
    }
    grid.sync();
    // the gather of step k, then phase 1 of step k-1 (or the result)
    const Fixed f = fixed_of(__ldcg(bins.gmax + k), dhw);
    m = 0;
    for (int w = first >> 5; w < ntasks; w += stride >> 5) {
      const Row r = row_at(w, D, H, W);
      const int p = (r.z * H + r.y) * W + r.x;
      float ds[3], G[3] = {0.0f, 0.0f, 0.0f};
      gather_row<3>(bins, 0, r, H, W, f, wacc, ds);
      float* ob = dvec + r.b * 3 * dhw + p;
      if (r.in) {
#pragma unroll
        for (int a = 0; a < 3; ++a) G[a] = __fadd_rn(__ldcg(ob + a * dhw), ds[a]);
      }
      if (k == 0) {
        if (r.in) {
#pragma unroll
          for (int a = 0; a < 3; ++a) ob[a * dhw] = __fmul_rn(G[a], scale);
        }
        continue;
      }
      if (r.in) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          __stcg(gout + (r.b * 3 + a) * dhw + p, G[a]);
        }
      }
      own_terms(steps + (k - 1) * slot, r, p, G, dvec, bins,
                bins.csum + (k - 1) * bins.nchunks * kCopies, m, D, H, W);
    }
    if (k > 0) max_into(bins.gmax + k - 1, m, shm);
  }
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

// The voxel pairs of B volumes of (D, H, W).
long long pairs_of(int B, int D, int H, int W) {
  return (long long)B * D * H * ((W + 1) / 2);
}

// The bins in `base` (on a 16-byte boundary, else cudaErrorInvalidValue),
// their counted part zeroed on `s`.
cudaError_t bins_of(int* base, int B, int C, int D, int H, int W,
                    int nsteps, cudaStream_t s, Bins* bins, int Ds = 0) {
  if (reinterpret_cast<std::uintptr_t>(base) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  long long zeroed = 0;
  bins_layout(base, B, C, D, H, W, nsteps, bins, &zeroed, Ds);
  return cudaMemsetAsync(base, 0, sizeof(int) * zeroed, s);
}

// co-resident blocks of each cooperative kernel, per device
int fwd_resident[kMaxDevices];
int bwd_resident[kMaxDevices];
int dsrc_resident[kMaxDevices];
int dsrc_slab_resident[kMaxDevices];

}  // namespace

// src (B,C,Ds,H,W), flow (B,3,D,H,W), out (B,C,D,H,W): float32, contiguous,
// on the device of `stream`; out's plane z samples the source at global
// depth (z + z0) + flow_z, clamped to [-2, Ds+1] (a whole volume: Ds = D,
// z0 = 0).  src and flow may alias; out must not.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int dfmir_warp3d_fwd(const float* src, const float* flow,
                                float* out, int B, int C, int D, int H, int W,
                                int Ds, int z0, void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0 || C == 0) return (int)cudaSuccess;
  warp3d_trilinear_fwd<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      src, flow, out, (int)n, C, D, H, W, Ds, z0);
  return (int)cudaGetLastError();
}

// The flow gradient of dfmir_warp3d_fwd for the output cotangent g
// (B,C,D,H,W): writes dflow (B,3,D,H,W), summed over channels; src
// (B,C,Ds,H,W) and z0 as there.  float32, contiguous, on the device of
// `stream`.  src and flow may alias; dflow must not alias any input.
// Returns the launch's cudaError_t.
extern "C" int dfmir_warp3d_bwd_dflow(const float* src, const float* flow,
                                      const float* g, float* dflow, int B,
                                      int C, int D, int H, int W, int Ds,
                                      int z0, void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool slab = Ds != D || z0 != 0;
  auto kernel = C == 1 ? (slab ? warp3d_trilinear_bwd_dflow<true, true>
                               : warp3d_trilinear_bwd_dflow<true, false>)
                       : (slab ? warp3d_trilinear_bwd_dflow<false, true>
                               : warp3d_trilinear_bwd_dflow<false, false>);
  kernel<<<blocks_for(n), kThreads, 0, s>>>(src, flow, g, dflow, (int)n, C,
                                            D, H, W, Ds, z0);
  return (int)cudaGetLastError();
}

// The int32s of the `bins` buffer that dfmir_warp3d_bwd_dsrc (nsteps 1)
// and dfmir_vecint3d_bwd (C 3) take for B volumes of (D, H, W).
extern "C" long long dfmir_bins3d_ints(int B, int C, int D, int H, int W,
                                       int nsteps) {
  long long zeroed = 0;
  return bins_layout(nullptr, B, C, D, H, W, nsteps, nullptr, &zeroed);
}

// The source gradient of dfmir_warp3d_fwd for the output cotangent g
// (B,C,D,H,W): writes every voxel of dsrc (B,C,D,H,W), bitwise the same on
// every run.  Needs no source values.  `bins` holds dfmir_bins3d_ints(B, C,
// D, H, W, 1) int32s on a 16-byte boundary.  One cooperative launch of
// `blocks` blocks, or, when 0, up to the co-resident limit.  float32,
// contiguous, on the device of `stream`; dsrc and bins alias nothing.
// Returns the first cudaError_t.
extern "C" int dfmir_warp3d_bwd_dsrc(const float* flow, const float* g,
                                     float* dsrc, int* bins, int B, int C,
                                     int D, int H, int W, int blocks,
                                     void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0 || C == 0) return (int)cudaSuccess;
  Bins b;
  const cudaError_t err =
      bins_of(bins, B, C, D, H, W, 1, (cudaStream_t)stream, &b);
  if (err != cudaSuccess) return (int)err;
  int npairs = (int)n, first = 0, last = 3;
  void* args[] = {&flow, &g, &dsrc, &b, &npairs, &C,
                  &D,    &H, &W,    &first, &last};
  return (int)launch_chain((const void*)warp3d_trilinear_bwd_dsrc,
                           dsrc_resident, n, blocks, args, stream);
}

// The int32s of the `bins` buffer that dfmir_warp3d_bwd_dsrc_slab takes for
// B slabs of (D, H, W) of sources of Ds planes.
extern "C" long long dfmir_bins3d_slab_ints(int B, int C, int D, int H,
                                            int W, int Ds) {
  long long zeroed = 0;
  return bins_layout(nullptr, B, C, D, H, W, 1, nullptr, &zeroed, Ds);
}

// B5 on a slab: flow (B,3,D,H,W) and g (B,C,D,H,W) are planes [z0, z0 + D)
// of a volume of Ds planes, as dfmir_warp3d_fwd takes them; writes every
// voxel of sums (B,C,Ds,H,W), int64: each source voxel's sum of this
// slab's terms in the fixed point of `gmax` (a device uint32: the bits of
// max|g| over the whole volume's cotangent, the same on every rank), e
// from Ds*H*W voxels.  Summed over the slabs, they are the integers of
// dfmir_warp3d_bwd_dsrc on the whole volume, whose value is sum * 2^-e
// (ops/warp.py::from_fixed).  `bins` holds dfmir_bins3d_slab_ints(B, C, D,
// H, W, Ds) int32s on a 16-byte boundary.  One cooperative launch as
// dfmir_warp3d_bwd_dsrc's.  Bitwise the same on every run.
extern "C" int dfmir_warp3d_bwd_dsrc_slab(const float* flow, const float* g,
                                          long long* sums, int* bins,
                                          const unsigned* gmax, int B, int C,
                                          int D, int H, int W, int Ds,
                                          int z0, int blocks, void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0 || C == 0) return (int)cudaSuccess;
  if (z0 < 0 || z0 + D > Ds) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Bins b;
  cudaError_t err = bins_of(bins, B, C, D, H, W, 1, s, &b, Ds);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(b.gmax, gmax, sizeof(unsigned),
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  int npairs = (int)n;
  void* args[] = {&flow, &g, &sums, &b, &npairs, &C, &D, &H, &W, &Ds, &z0};
  return (int)launch_chain((const void*)warp3d_trilinear_bwd_dsrc_slab,
                           dsrc_slab_resident, n, blocks, args, stream);
}

// The forward chain's bricks, {kBz, kBy, kBx, kHalo, kPadX}: the wrapper
// sizes `maxes` by the bricks, and chip_smoke.py accounts for the corners a
// run reads from L2.
extern "C" void dfmir_vecint3d_fwd_brick(int* dims) {
  dims[0] = kBz;
  dims[1] = kBy;
  dims[2] = kBx;
  dims[3] = kHalo;
  dims[4] = kPadX;
}

// VecInt forward: vec (B,3,D,H,W) -> out (B,3,D,H,W), nsteps squarings.
// With `save`, `steps` receives v_0..v_{n-1}, field k at k * slot floats
// (the backward's input; `slot` no smaller than a field); without, it is
// one (B,3,D,H,W) field (unused when nsteps is 0).  `maxes` holds a uint32
// a brick, B * ceil(D/kBz) * ceil(H/kBy) * ceil(W/kBx).  `blocks` 0 sizes
// the grid to the bricks, at most the co-resident limit.  float32,
// contiguous, on the device of `stream`; no buffer aliases another.
// Returns the launch's cudaError_t.
extern "C" int dfmir_vecint3d_fwd(const float* vec, float* steps,
                                  long long slot, float* out,
                                  unsigned* maxes, int B, int D, int H,
                                  int W, int nsteps, int save, int blocks,
                                  void* stream) {
  const long long nval = 3LL * B * D * H * W;
  if (nval == 0) return (int)cudaSuccess;
  if (save && nsteps > 0 && slot < nval) return (int)cudaErrorInvalidValue;
  if (blocks == 0) {   // every brick at once, or as many as fit
    const cudaError_t err =
        resident_blocks((const void*)vecint3d_fwd, fwd_resident, &blocks);
    if (err != cudaSuccess) return (int)err;
    const long long bricks = (long long)B * ((D + kBz - 1) / kBz) *
                             ((H + kBy - 1) / kBy) * ((W + kBx - 1) / kBx);
    if (bricks < blocks) blocks = (int)bricks;
  }
  // every row of every field on 16 bytes: the boxes staged by cp.async
  auto on16 = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  int aligned = W % 4 == 0 && on16(out) && (nsteps == 0 || on16(steps)) &&
                (!save || slot % 4 == 0);
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&vec, &steps, &slot,   &out,  &maxes,   &B,     &D,
                  &H,   &W,     &nsteps, &save, &aligned, &scale};
  return (int)launch_chain((const void*)vecint3d_fwd, fwd_resident, 0,
                           blocks, args, stream);
}

// VecInt backward: steps the forward's saved v_0..v_{n-1}, field k at k *
// slot floats; g (B,3,D,H,W) the cotangent of v_n; writes dvec
// (B,3,D,H,W), bitwise the same on every run.  `scratch` is two
// (B,3,D,H,W) fields, one after the other (unused when nsteps < 2); `bins`
// holds dfmir_bins3d_ints(B, 3, D, H, W, nsteps) int32s on a 16-byte
// boundary.
// `blocks` as in the forward.  float32, contiguous, on the device of
// `stream`; dvec, scratch and bins alias nothing.  Returns the first
// cudaError_t.
extern "C" int dfmir_vecint3d_bwd(const float* steps, long long slot,
                                  const float* g, float* scratch, int* bins,
                                  float* dvec, int B, int D, int H, int W,
                                  int nsteps, int blocks, void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0) return (int)cudaSuccess;
  Bins b;
  const cudaError_t err =
      bins_of(bins, B, 3, D, H, W, nsteps, (cudaStream_t)stream, &b);
  if (err != cudaSuccess) return (int)err;
  int npairs = (int)n;
  float scale = ldexpf(1.0f, -nsteps);
  void* args[] = {&steps, &slot, &g,      &scratch, &b, &dvec, &npairs,
                  &B,     &D,    &H,      &W,       &nsteps, &scale};
  return (int)launch_chain((const void*)vecint3d_bwd, bwd_resident, n,
                           blocks, args, stream);
}
