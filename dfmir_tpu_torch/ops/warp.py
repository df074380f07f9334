"""Dense-flow spatial-transformer warps.

The reference SpatialTransformer (``identity + flow`` in pixel units,
normalised to [-1, 1] and sampled by ``grid_sample(align_corners=True,
padding_mode='zeros')``) is exactly a sample of the source at the absolute
pixel coordinates ``identity + flow`` with zero padding outside the image;
that is what is computed here, corner by corner, without ``grid_sample``.

Layout: NCHW.  ``src (B, C, *spatial)``, ``flow (B, nd, *spatial)`` where
``flow[:, i]`` displaces spatial axis ``i``.

``impl``: ``"torch"`` is the plain version below (differentiable by
autograd); ``"cuda"`` is the hand-written kernels (``ops/warp_cuda.py``):
2-D bilinear and 3-D trilinear, forward and backward; ``"auto"`` sends 2-D
bilinear and 3-D trilinear float32 CUDA tensors to the kernels and
everything else (nearest, 1-D, CPU tensors) to the plain version.  3-D
accepts the mode names ``"bilinear"`` and ``"trilinear"`` alike, as the JAX
package does.  ``warp_bwd_plain`` is the backward kernels' plain version.
With ``z0`` a 3-D warp takes a slab of a volume split along D over ranks
(``parallel/mesh.py``): the output's planes from plane ``z0`` of the whole
source, each sampling the source as the whole volume's rows do.
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.ops import warp_cuda


def identity_grid(spatial, dtype=torch.float32, device=None,
                  z0: int = 0) -> torch.Tensor:
    """Pixel-coordinate identity grid, shape (nd, *spatial); the first
    axis counts from ``z0`` (a slab's first plane)."""
    axes = [torch.arange(s, dtype=dtype, device=device) for s in spatial]
    axes[0] = axes[0] + z0      # exact: integers below 2^24
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def _gather(src, lin):
    """src (B, C, N) flat; lin (B, n) int64 -> (B, C, n)."""
    return torch.gather(src, 2, lin[:, None, :].expand(-1, src.shape[1], -1))


def _corner(src_flat, spatial, idx):
    """Values of src at integer coords ``idx`` (one (B, n) tensor per axis),
    zero where any coordinate falls outside the image."""
    valid = None
    lin = None
    for size, i in zip(spatial, idx):
        ok = (i >= 0) & (i <= size - 1)
        valid = ok if valid is None else valid & ok
        ic = i.clamp(0, size - 1)
        lin = ic if lin is None else lin * size + ic
    v = _gather(src_flat, lin)
    return v * valid[:, None, :].to(src_flat.dtype)


def _sample_linear(src, coords):
    """1/2/3-D (bi/tri)linear sample; coords (B, nd, n) absolute pixels."""
    B, C = src.shape[:2]
    spatial = src.shape[2:]
    nd = len(spatial)
    flat = src.reshape(B, C, -1)
    lo = [torch.floor(coords[:, i]) for i in range(nd)]
    w = [(coords[:, i] - lo[i])[:, None, :] for i in range(nd)]
    lo = [l.long() for l in lo]
    one = torch.ones((), dtype=src.dtype, device=src.device)
    if nd == 2:
        # the XLA path's association order (dfmir_tpu/ops/warp.py:111-116)
        (y0, x0), (wy, wx) = lo, w
        v00 = _corner(flat, spatial, (y0, x0))
        v01 = _corner(flat, spatial, (y0, x0 + 1))
        v10 = _corner(flat, spatial, (y0 + 1, x0))
        v11 = _corner(flat, spatial, (y0 + 1, x0 + 1))
        return (v00 * (one - wy) * (one - wx) + v01 * (one - wy) * wx
                + v10 * wy * (one - wx) + v11 * wy * wx)
    if nd == 1:
        (x0,), (wx,) = lo, w
        return (_corner(flat, spatial, (x0,)) * (one - wx)
                + _corner(flat, spatial, (x0 + 1,)) * wx)
    out = 0.0
    (z0, y0, x0), (wz, wy, wx) = lo, w
    for dz, fz in ((0, one - wz), (1, wz)):
        for dy, fy in ((0, one - wy), (1, wy)):
            for dx, fx in ((0, one - wx), (1, wx)):
                v = _corner(flat, spatial, (z0 + dz, y0 + dy, x0 + dx))
                out = out + v * fz * fy * fx
    return out


def _sample_nearest(src, coords):
    """Nearest sample; rounds half to even (torch.round), like jnp.rint and
    grid_sample's nearbyint."""
    B, C = src.shape[:2]
    spatial = src.shape[2:]
    idx = [torch.round(coords[:, i]).long() for i in range(len(spatial))]
    return _corner(src.reshape(B, C, -1), spatial, idx)


_LINEAR_MODES = {1: ("bilinear", "linear"), 2: ("bilinear",),
                 3: ("bilinear", "trilinear")}


def grid_sample_pixel(src, coords, mode="bilinear"):
    """Sample ``src`` at absolute pixel coordinates, zero padding outside.

    src:    (B, C, *spatial)
    coords: (B, nd, *out_spatial) absolute pixel position of each output point.
    """
    nd = coords.shape[1]
    if nd not in _LINEAR_MODES or src.ndim != nd + 2:
        raise ValueError(f"unsupported ndims={nd} for src of shape "
                         f"{tuple(src.shape)}")
    out_spatial = coords.shape[2:]
    flat_coords = coords.reshape(coords.shape[0], nd, -1)
    if mode in _LINEAR_MODES[nd]:
        out = _sample_linear(src, flat_coords)
    elif mode == "nearest":
        out = _sample_nearest(src, flat_coords)
    else:
        raise ValueError(f"unsupported mode={mode!r} / ndims={nd}")
    return out.reshape(src.shape[:2] + out_spatial)


# the modes the CUDA kernels take, by ndims
_KERNEL_MODES = {2: ("bilinear",), 3: ("bilinear", "trilinear")}


def _kernel_takes(src, flow, mode):
    return (mode in _KERNEL_MODES.get(flow.shape[1], ()) and src.is_cuda
            and src.dtype == torch.float32 and flow.dtype == torch.float32)


def warp(src, flow, mode="bilinear", impl="auto", z0=None):
    """Warp ``src`` by the dense displacement ``flow`` (SpatialTransformer).

    src:  (B, C, *spatial)
    flow: (B, nd, *spatial) pixel-unit displacements, flow[:, i] along axis i.
    impl: 'auto' | 'torch' | 'cuda'.
    z0:   a slab (3-D): ``flow`` holds the output's planes ``[z0, z0 + D)``
          of the whole source ``src`` (B, C, Ds, H, W), plane z sampling
          depth (z + z0) + flow_z (``warp_cuda.Warp3dSlabFunction``; the
          source takes no gradient there).
    """
    if impl == "auto":
        impl = "cuda" if _kernel_takes(src, flow, mode) else "torch"
    if impl == "cuda":
        nd = flow.shape[1]
        if mode not in _KERNEL_MODES.get(nd, ()):
            raise ValueError(f"the CUDA warp kernels are 2-D bilinear and 3-D "
                             f"trilinear only, got mode={mode!r} ndims={nd}")
        if z0 is not None:
            if nd != 3:
                raise ValueError(f"a slab warp is 3-D, got ndims={nd}")
            return warp_cuda.Warp3dSlabFunction.apply(
                src.contiguous(), flow.contiguous(), int(z0))
        fn = warp_cuda.Warp2dFunction if nd == 2 else warp_cuda.Warp3dFunction
        return fn.apply(src.contiguous(), flow.contiguous())
    if impl != "torch":
        raise ValueError(f"impl must be 'auto', 'torch' or 'cuda', got {impl!r}")
    grid = identity_grid(flow.shape[2:], dtype=flow.dtype, device=flow.device,
                         z0=0 if z0 is None else int(z0))
    return grid_sample_pixel(src, grid[None] + flow, mode=mode)


def warp_bwd_plain(src, flow, g, need_dsrc: bool = True,
                   need_dflow: bool = True, z0=None):
    """The backward kernels' plain version, 2-D or 3-D: the gradients of
    ``warp(src, flow, impl="torch", z0=z0)`` for the output cotangent
    ``g``, by autograd.  Returns ``(dsrc, dflow)``, each None unless asked
    for.  ``src`` and ``flow`` may be one tensor; the two gradients then
    come back apart, as the kernels return them."""
    with torch.enable_grad():
        s = src.detach().requires_grad_(need_dsrc)
        f = flow.detach().requires_grad_(need_dflow)
        out = warp(s, f, impl="torch", z0=z0)
        wrt = [t for t in (s, f) if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g))
    return (next(grads) if need_dsrc else None,
            next(grads) if need_dflow else None)


def _fixed_point_exponent(m: torch.Tensor, dhw: int) -> int:
    """The exponent e of the fixed point of the source gradients for
    max|g| = m (a float32 scalar, finite) over dhw voxels or pixels, as
    ``csrc/fixed_point.cuh::fixed_of`` takes it: m < 2^E from m's exponent
    field, dhw < 2^L, e = min(61 - E - L, 100), so no sum of at most dhw
    terms of at most m reaches 2^61."""
    bits = int(m.reshape(1).view(torch.int32)[0])
    return min(61 - (max(bits >> 23, 1) - 126) - dhw.bit_length(), 100)


def warp3d_dsrc_binned_plain(flow, g):
    """B5's source gradient as the kernel sums it, in plain PyTorch: the
    dsrc of ``warp(src, flow, impl="torch")`` for the cotangent ``g`` (B, C,
    D, H, W), float32.  Each target's term for corner k is formed as the
    kernel forms it, ((g * fx) * fy) * fz, on coordinates clamped to
    [-2, S+1], scaled by 2^e, rounded to an int64 and summed exactly with
    ``index_add_``; the sum times 2^-e.  Integer sums are order-free, so
    the kernel equals this bit for bit.  A non-finite g gives NaN
    everywhere (the kernel's rule); a zero g exactly 0."""
    B, C, D, H, W = g.shape
    dhw = D * H * W
    m = g.abs().max()
    if not bool(torch.isfinite(m)):
        return torch.full_like(g, float("nan"))
    e = _fixed_point_exponent(m.float(), dhw)
    spatial = (D, H, W)
    grid = identity_grid(spatial, dtype=flow.dtype, device=flow.device)
    coords = (grid[None] + flow).reshape(B, 3, dhw)
    lo, w = [], []
    for i, size in enumerate(spatial):
        c = coords[:, i].clamp(-2.0, size + 1.0)
        f = torch.floor(c)
        lo.append(f.long())
        w.append((c - f)[:, None])                      # (B, 1, N)
    gf = g.reshape(B, C, dhw)
    base = torch.arange(B * C, device=g.device).reshape(B, C, 1) * dhw
    total = torch.zeros(B * C * dhw, dtype=torch.int64, device=g.device)
    for k in range(8):
        d = (k >> 2, (k >> 1) & 1, k & 1)
        idx = [lo[i] + d[i] for i in range(3)]
        valid = ((idx[0] >= 0) & (idx[0] < D) & (idx[1] >= 0) & (idx[1] < H)
                 & (idx[2] >= 0) & (idx[2] < W))
        fz, fy, fx = (w[i] if d[i] else 1.0 - w[i] for i in range(3))
        term = ((gf * fx) * fy) * fz
        q = torch.round(term * 2.0 ** e).long()
        lin = (idx[0] * H + idx[1]) * W + idx[2]
        at = (base + lin[:, None]).expand(B, C, dhw)
        sel = valid[:, None].expand(B, C, dhw)
        total.index_add_(0, at[sel], q[sel])
    return (total.to(torch.float32) * 2.0 ** -e).reshape(g.shape)


def warp2d_dsrc_fixed_plain(flow, g):
    """The 2-D source gradient as B2 (``warp2d_bwd_cuda``) and
    ``vecint2d_bwd`` sum it, in plain PyTorch: the dsrc of ``warp(src,
    flow, impl="torch")`` for the cotangent ``g`` (B, C, H, W), float32.
    Each target's term for corner (dy, dx) is formed as the kernel forms
    it, (g * fx) * fy, on
    coordinates clamped to [-2, S+1]; item b's terms are scaled by 2^e_b,
    e_b from max|g[b]| over its channels and H*W pixels, rounded to int64
    and summed exactly with ``index_add_``; the sum times 2^-e_b.  A
    non-finite item gives NaN over that item; a zero one exactly 0."""
    B, C, H, W = g.shape
    hw = H * W
    grid = identity_grid((H, W), dtype=flow.dtype, device=flow.device)
    coords = (grid[None] + flow).reshape(B, 2, hw)
    lo, w = [], []
    for i, size in enumerate((H, W)):
        c = coords[:, i].clamp(-2.0, size + 1.0)
        f = torch.floor(c)
        lo.append(f.long())
        w.append((c - f)[:, None])                      # (B, 1, N)
    m = g.abs().reshape(B, -1).amax(dim=1)
    finite = torch.isfinite(m)
    e = [_fixed_point_exponent(m[b], hw) if finite[b] else 0
         for b in range(B)]
    scale = torch.tensor([2.0 ** x for x in e], dtype=g.dtype,
                         device=g.device).reshape(B, 1, 1)
    gf = g.reshape(B, C, hw)
    base = torch.arange(B * C, device=g.device).reshape(B, C, 1) * hw
    total = torch.zeros(B * C * hw, dtype=torch.int64, device=g.device)
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = lo[0] + dy, lo[1] + dx
            valid = (y >= 0) & (y < H) & (x >= 0) & (x < W)
            fy = w[0] if dy else 1.0 - w[0]
            fx = w[1] if dx else 1.0 - w[1]
            q = torch.round(((gf * fx) * fy) * scale).long()
            at = (base + (y * W + x)[:, None]).expand(B, C, hw)
            sel = valid[:, None].expand(B, C, hw)
            total.index_add_(0, at[sel], q[sel])
    out = total.reshape(B, C, hw).to(torch.float32) * (1.0 / scale)
    out[~finite] = float("nan")
    return out.reshape(g.shape)

