// Two yardsticks of the binned 3-D source gradient of csrc/warp3d.cu (B5),
// timed beside it by chip_smoke.py and on no path of the port:
// - dfmir_yard_dsrc3d_phased: B5's kernel with its 4 phases as 4 plain
//   launches, each grid sized to its work, in place of one cooperative
//   launch with a grid.sync() between phases (or one phase alone, to time
//   the phases);
// - dfmir_yard_dsrc3d_scatter64: B5's fixed-point terms scattered to the
//   corners with int64 atomicAdd, then converted (3 launches): order-free,
//   so bit-equal to B5, but not binned.  Against B5 it separates what
//   binning gains from what determinism costs (the float32 atomic scatter
//   that B5 replaced took 65-72 us at (1,3,80^3) on an H100).
// chip_smoke.py builds this file alone with nvcc into a library of its
// own; it includes the kernels' source for the device functions, and
// csrc/*.cu, which the port's library is built from, does not include it.

#include "../warp3d.cu"

namespace {

// max|g|'s bits over n values into *gmax.
__global__ void __launch_bounds__(kThreads)
    yard_max(const float* __restrict__ g, unsigned* gmax, long long n) {
  __shared__ unsigned sh[kWarps];
  unsigned m = 0;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    m = max(m, abs_bits(__ldg(g + i)));
  }
  max_into(gmax, m, sh);
}

// Each target's term for each inside corner, as B5's gather forms it, in
// B5's fixed point, added to its corner's int64 with atomicAdd.
__global__ void __launch_bounds__(kThreads)
    yard_scatter64(const float* __restrict__ flow, const float* __restrict__ g,
                   unsigned long long* acc, const unsigned* gmax, int npairs,
                   int C, int D, int H, int W) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= npairs) return;
  const Pair q = pair_at(j, D, H, W);
  const int hw = H * W, dhw = D * hw;
  const Fixed f = fixed_of(__ldg(gmax), dhw);
  float2 u[3];
  Trilinear t[2];
  trilinear_pair<Path::kReadOnly>(flow + q.b * 3 * dhw, q, dhw, D, H, W, u,
                                  t);
  for (int c = 0; c < C; ++c) {
    const int plane = (q.b * C + c) * dhw;
    const float2 gv = load2<Path::kReadOnly>(g + plane + q.p, q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float gc = i ? gv.y : gv.x;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (!((t[i].mask >> k) & 1u)) continue;
        const float term = __fmul_rn(
            __fmul_rn(__fmul_rn(gc, weight(t[i].wx, k & 1)),
                      weight(t[i].wy, (k >> 1) & 1)),
            weight(t[i].wz, k >> 2));
        atomicAdd(acc + plane + (t[i].base + corner(k, hw, W)),
                  (unsigned long long)__float2ll_rn(
                      __fmul_rn(term, f.scale)));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    yard_to_float(const long long* __restrict__ acc, const unsigned* gmax,
                  float* __restrict__ dsrc, long long n, int dhw) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const Fixed f = fixed_of(__ldg(gmax), dhw);
  dsrc[i] = f.finite ? __fmul_rn(__ll2float_rn(acc[i]), f.inv)
                     : __int_as_float(0x7fffffff);
}

}  // namespace

// As dfmir_warp3d_bwd_dsrc (same arguments but `blocks`), as 4 launches;
// `phase` 0..3 launches that phase alone (0 with the zeroing), -1 all 4.
extern "C" int dfmir_yard_dsrc3d_phased(const float* flow, const float* g,
                                        float* dsrc, int* bins, int B, int C,
                                        int D, int H, int W, int phase,
                                        void* stream) {
  const long long n = pairs_of(B, D, H, W);
  if (n == 0 || C == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  Bins b;
  long long zeroed = 0;
  bins_layout(bins, B, C, D, H, W, 1, &b, &zeroed);
  if (phase <= 0) {
    const cudaError_t err = bins_of(bins, B, C, D, H, W, 1, s, &b);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grids[4] = {blocks_for(n), (unsigned)b.nchunks,
                             blocks_for(n),
                             blocks_for((long long)B * D * H * W)};
  for (int p = 0; p < 4; ++p) {
    if (phase >= 0 && p != phase) continue;
    warp3d_trilinear_bwd_dsrc<<<grids[p], kThreads, 0, s>>>(
        flow, g, dsrc, b, (int)n, C, D, H, W, p, p);
  }
  return (int)cudaGetLastError();
}

// B5's result by an int64 atomic scatter: `acc` holds B*C*D*H*W + 1
// int64s (the last one max|g|'s slot), zeroed here.
extern "C" int dfmir_yard_dsrc3d_scatter64(const float* flow, const float* g,
                                           float* dsrc, long long* acc, int B,
                                           int C, int D, int H, int W,
                                           void* stream) {
  const long long n = pairs_of(B, D, H, W);
  const long long nval = (long long)B * C * D * H * W;
  if (n == 0 || C == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned* gmax = reinterpret_cast<unsigned*>(acc + nval);
  const cudaError_t err =
      cudaMemsetAsync(acc, 0, sizeof(long long) * (nval + 1), s);
  if (err != cudaSuccess) return (int)err;
  yard_max<<<blocks_for(nval), kThreads, 0, s>>>(g, gmax, nval);
  yard_scatter64<<<blocks_for(n), kThreads, 0, s>>>(
      flow, g, reinterpret_cast<unsigned long long*>(acc), gmax, (int)n, C,
      D, H, W);
  yard_to_float<<<blocks_for(nval), kThreads, 0, s>>>(acc, gmax, dsrc, nval,
                                                      D * H * W);
  return (int)cudaGetLastError();
}
