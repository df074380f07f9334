"""The Hopper kernels for the 2-D bilinear and 3-D trilinear warps, forward
and backward, and for VecInt's 2-D and 3-D scaling-and-squaring chains.

Each launcher replaces a Pallas kernel of ``dfmir_tpu/ops/warp_pallas.py``:

- ``warp2d_cuda``: ``_kernel`` / ``warp2d_banded`` (``csrc/warp2d.cu``);
- ``warp2d_bwd_cuda``: ``_bwd_kernel`` / ``warp2d_banded_bwd`` (both
  gradients, one launch; the source gradient summed in an int64 fixed
  point scaled per batch item, in one cooperative launch, bitwise
  reproducible);
- ``vecint2d_fwd_cuda``: ``_kernel`` as JAX's ``vecint`` calls it, 7 times
  in a chain: the whole chain in one launch of a thread-block cluster a
  batch item, the field in the cluster's shared memory between steps;
- ``vecint2d_bwd_cuda``: ``_bwd_kernel`` as ``jax.vjp`` of ``vecint``
  calls it: the chain's whole gradient in one launch of a thread-block
  cluster a batch item, its source gradients summed in an int64 fixed
  point, bitwise reproducible;
- ``warp3d_cuda``: ``_kernel3d`` / ``warp3d_banded`` (``csrc/warp3d.cu``),
  on a whole volume or, with ``z0``, on a slab of one split along D;
- ``warp3d_bwd_dflow_cuda``: ``_bwd_kernel3d_dflow`` /
  ``warp3d_banded_bwd_dflow``, on a volume or a slab as ``warp3d_cuda``;
- ``warp3d_bwd_dsrc_cuda``: ``_bwd_kernel3d_dsrc`` /
  ``warp3d_banded_bwd_dsrc``: a binned gather summed in an int64 fixed
  point, bitwise reproducible, in one cooperative launch;
- ``vecint3d_fwd_cuda``: ``_kernel3d`` as JAX's ``vecint`` calls it at 3-D,
  the whole chain in one cooperative launch, each step reading the field
  from bricks staged in shared memory;
- ``vecint3d_bwd_cuda``: ``_bwd_kernel3d_dflow`` and ``_bwd_kernel3d_dsrc``
  as ``jax.vjp`` of ``vecint`` calls them: the whole gradient in one
  cooperative launch, its source gradients binned as B5's.

The designs are in the notes of the sources; ``ops/_build.py`` builds them.
Their plain versions are ``ops/warp.py``'s ``warp(..., impl="torch")`` and
``warp_bwd_plain``, and ``ops/integrate.py``'s ``vecint(..., impl="torch")``
and ``vecint_bwd_plain``, which the CPU tests and the on-card comparison
use; the fixed-point source gradients' plain models are
``ops/warp.py``'s ``warp2d_dsrc_fixed_plain`` and
``warp3d_dsrc_binned_plain`` and ``ops/integrate.py``'s
``vecint2d_bwd_fixed_plain``, equal to the kernels bit for bit.
``Warp2dFunction``, ``Warp3dFunction``, ``Warp3dSlabFunction``,
``VecInt2dFunction`` and ``VecInt3dFunction`` tie the kernels together for
autograd, as the custom VJPs ``_warp2d`` / ``_warp3d`` do in the JAX
package.

Every launcher checks its tensors with one cheap test and, only when that
fails, the detailed checks that say what is wrong; then ``_launch`` calls
the library on the current stream.  A CPU tensor, a refused launch or a
tensor the kernel does not take raises: nothing falls back.

``LAUNCHES`` counts the launches of each kernel by name, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dfmir_tpu_torch.ops import _build

FWD = "warp2d_bilinear_fwd"
BWD = "warp2d_bilinear_bwd"
VECINT_FWD = "vecint2d_fwd"
VECINT_BWD = "vecint2d_bwd"
FWD3D = "warp3d_trilinear_fwd"
DFLOW3D = "warp3d_trilinear_bwd_dflow"
DSRC3D = "warp3d_trilinear_bwd_dsrc"
VECINT3D_FWD = "vecint3d_fwd"
VECINT3D_BWD = "vecint3d_bwd"
LAUNCHES = {FWD: 0, BWD: 0, VECINT_FWD: 0, VECINT_BWD: 0, FWD3D: 0,
            DFLOW3D: 0, DSRC3D: 0, VECINT3D_FWD: 0, VECINT3D_BWD: 0}

_F32 = torch.float32
_INT_LIMIT = 2 ** 31


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(src, flow, name, nd, z0=None):
    """Raise, naming the fault, unless src (B, C, *S) and flow (B, nd, *S),
    with ``nd`` spatial axes, are float32, contiguous and on one CUDA
    device.  With ``z0`` the flow may be a slab: (B, nd, D, *S[1:]), the
    output's planes ``[z0, z0 + D)`` of the source, ``0 <= z0 <= S[0] -
    D``."""
    if not (src.is_cuda and flow.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors; on the CPU use "
                         f"impl='torch'")
    if src.device != flow.device:
        raise ValueError(f"src on {src.device}, flow on {flow.device}")
    if src.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"{name} is float32 only, got {src.dtype}, "
                        f"{flow.dtype}")
    if src.ndim != nd + 2 or flow.ndim != nd + 2:
        raise ValueError(f"expected {nd + 2}-D src and flow, got "
                         f"{tuple(src.shape)} and {tuple(flow.shape)}")
    B, C, *spatial = src.shape
    if z0 is None:
        if tuple(flow.shape) != (B, nd, *spatial):
            raise ValueError(f"flow shape {tuple(flow.shape)} does not match "
                             f"src {tuple(src.shape)}: expected "
                             f"{(B, nd, *spatial)}")
    else:
        D = flow.shape[2]
        if (tuple(flow.shape) != (B, nd, D, *spatial[1:])
                or not 0 <= z0 <= spatial[0] - D):
            raise ValueError(f"flow {tuple(flow.shape)} from plane {z0} is "
                             f"not a slab of src {tuple(src.shape)}: expected "
                             f"(B, {nd}, D, ...) with 0 <= z0 <= "
                             f"{spatial[0]} - D")
    if not (src.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if B * max(C, nd) * math.prod(spatial) >= _INT_LIMIT:
        raise ValueError(f"{tuple(src.shape)} is too large for int sizes")


def _device(src, flow, name, nd) -> int:
    """The CUDA device index of src and flow when ``_check`` would pass them,
    by one cheap test; otherwise ``_check`` raises."""
    d = src.get_device()
    s = src.shape
    if not (d >= 0 and flow.get_device() == d and src.dtype is _F32
            and flow.dtype is _F32 and len(s) == nd + 2
            and flow.shape == (s[0], nd, *s[2:]) and src.is_contiguous()
            and flow.is_contiguous() and src.numel() < _INT_LIMIT
            and flow.numel() < _INT_LIMIT):
        _check(src, flow, name, nd)
    return d


def _check_g(g, like, shape=None):
    """Raise unless the cotangent ``g`` is float32, contiguous, on
    ``like``'s device and of ``shape`` (``like``'s by default)."""
    shape = like.shape if shape is None else torch.Size(shape)
    if not (g.get_device() == like.get_device() and g.dtype is _F32
            and g.shape == shape and g.is_contiguous()):
        if g.device != like.device or g.dtype != torch.float32:
            raise TypeError(f"g must be float32 on {like.device}, got "
                            f"{g.dtype} on {g.device}")
        raise ValueError(f"g must be contiguous and of the output's shape "
                         f"{tuple(shape)}, got {tuple(g.shape)}")


def _launch(name, entry, device, *args):
    """Call the library's ``entry`` with ``args`` and the current stream of
    CUDA device ``device`` (an index); raise on a refused launch, count it.

    The lean path: the raw stream is read without a device guard, and the
    guard is entered only when ``device`` is not the current device.  The
    library and its bound, typed functions are cached (``_build.load`` and
    ctypes' own attribute cache)."""
    fn = getattr(_build.load(), entry)
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch._C._cuda_getDevice():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def warp2d_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: src (B, C, H, W), flow (B, 2, H, W), both
    float32, contiguous and on one CUDA device; returns a fresh (B, C, H, W).

    ``src`` and ``flow`` may be the same tensor (a self-warp)."""
    device = _device(src, flow, "warp2d_cuda", 2)
    out = torch.empty_like(src)
    _launch(FWD, "dfmir_warp2d_fwd", device, src.data_ptr(), flow.data_ptr(),
            out.data_ptr(), *src.shape)
    return out


@functools.lru_cache(maxsize=64)
def _scratch2d(B, C, H, W):
    return int(_build.load().dfmir_warp2d_bwd_scratch(B, C, H, W))


def warp2d_bwd_cuda(src: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                    need_dsrc: bool = True):
    """Launch the backward kernel for the cotangent ``g`` (B, C, H, W) of
    ``warp2d_cuda(src, flow)``; returns ``(dsrc, dflow)``, with ``dsrc``
    None unless ``need_dsrc`` (no max and no sums are then computed).

    Both are bitwise the same on every run: ``dflow`` is formed in
    autograd's order, and ``dsrc`` is summed in an int64 fixed point scaled
    per batch item, equal to ``ops.warp.warp2d_dsrc_fixed_plain(flow,
    g)``, in int64 scratch allocated here."""
    device = _device(src, flow, "warp2d_bwd_cuda", 2)
    _check_g(g, src)
    dflow = torch.empty_like(flow)
    dsrc = scratch = None
    if need_dsrc:
        dsrc = torch.empty_like(src)
        scratch = torch.empty(_scratch2d(*src.shape), dtype=torch.int64,
                              device=src.device)
    _launch(BWD, "dfmir_warp2d_bwd", device, src.data_ptr(), flow.data_ptr(),
            g.data_ptr(), dsrc.data_ptr() if need_dsrc else None,
            dflow.data_ptr(), scratch.data_ptr() if need_dsrc else None,
            *src.shape)
    return dsrc, dflow


def _check_steps(steps, g, device):
    """Raise unless ``steps`` is a float32 stack of g-shaped fields, each
    contiguous, on CUDA device ``device``."""
    if not (steps.get_device() == device and steps.dtype is _F32
            and steps.shape[1:] == g.shape and steps.stride()[1:] == g.stride()
            and steps.shape[0] * steps.stride(0) < _INT_LIMIT):
        raise ValueError(f"steps must be a float32 (n, "
                         f"{', '.join(map(str, g.shape))}) stack of "
                         f"contiguous fields on g's device, got {steps.dtype} "
                         f"{tuple(steps.shape)} on {steps.device}")


def vecint2d_fwd_cuda(vec: torch.Tensor, nsteps: int, save: bool):
    """Launch the VecInt forward chain on vec (B, 2, H, W), float32,
    contiguous, on a CUDA device: ``vec * 2**-nsteps`` squared ``nsteps``
    times in one launch of a thread-block cluster a batch item.  Returns
    ``(out, steps)``: the displacement field and, when ``save``, the
    (nsteps, B, 2, H, W) stack of the fields before each step, which the
    backward reads (else None; the launch then keeps the field in the
    cluster's shared memory or, for a field too large for it, two
    ping-pong buffers)."""
    device = _device(vec, vec, "vecint2d_fwd_cuda", 2)
    out = torch.empty_like(vec)
    if save:
        steps = vec.new_empty((nsteps, *vec.shape))
    else:
        steps = torch.empty_like(vec) if nsteps else None
    _launch(VECINT_FWD, "dfmir_vecint2d_fwd", device, vec.data_ptr(),
            None if steps is None else steps.data_ptr(), out.data_ptr(),
            vec.shape[0], *vec.shape[2:], nsteps, int(save), 0)
    return out, steps if save else None


def vecint2d_bwd_cuda(steps: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the VecInt backward chain: ``steps`` the forward's saved
    (nsteps, B, 2, H, W) stack, contiguous, ``g`` (B, 2, H, W) the cotangent
    of its output; returns the gradient of its input, in one launch of one
    thread-block cluster a batch item.  Its source gradients are summed in
    an int64 fixed point scaled per batch item, so the result is bitwise
    the same on every run and equal to
    ``ops.integrate.vecint2d_bwd_fixed_plain(steps, g)``."""
    device = _device(g, g, "vecint2d_bwd_cuda", 2)
    _check_steps(steps, g, device)
    if not steps.is_contiguous():
        raise ValueError("steps must be contiguous")
    dvec = torch.empty_like(g)
    sums = torch.empty(g.shape, dtype=torch.int64, device=g.device)
    _launch(VECINT_BWD, "dfmir_vecint2d_bwd", device, steps.data_ptr(),
            g.data_ptr(), sums.data_ptr(), dvec.data_ptr(), g.shape[0],
            *g.shape[2:], steps.shape[0], 0)
    return dvec


@functools.lru_cache(maxsize=64)
def _bins_ints(B, C, D, H, W, nsteps):
    return int(_build.load().dfmir_bins3d_ints(B, C, D, H, W, nsteps))


def _bins3d(g: torch.Tensor, nsteps: int) -> torch.Tensor:
    """The int32 scratch of the binned 3-D source gradient for the (B, C,
    D, H, W) cotangent ``g`` over ``nsteps`` steps (``csrc/warp3d.cu``,
    "THE BINNED SOURCE GRADIENT"): cell counts, their scan and the targets'
    list with their cotangents, 18 MB at (1, 3, 80, 80, 80)."""
    B, C, D, H, W = g.shape
    if B * (D + 1) * (H + 1) * (W + 1) + 4096 >= _INT_LIMIT:
        raise ValueError(f"{tuple(g.shape)} has too many cells for int "
                         f"sizes")
    return torch.empty(_bins_ints(B, C, D, H, W, nsteps), dtype=torch.int32,
                       device=g.device)


def stack3d(vec: torch.Tensor, nsteps: int) -> torch.Tensor:
    """An empty (nsteps, *vec.shape) stack for the 3-D chain whose fields
    each start on a 128-byte line: a view of rows of a multiple of 32
    floats, so that every field's rows start on 16 bytes wherever a fresh
    tensor's would and the forward stages them with 16-byte copies
    (``csrc/warp3d.cu``, "THE FORWARD CHAIN")."""
    slot = -(-vec.numel() // 32) * 32
    return vec.new_empty((nsteps, slot)).as_strided(
        (nsteps, *vec.shape), (slot, *vec.stride()))


@functools.lru_cache(maxsize=1)
def brick3d():
    """The 3-D forward chain's (brick z, y, x, most halo, x pad) in
    voxels (``csrc/warp3d.cu``, "THE FORWARD CHAIN")."""
    dims = (ctypes.c_int * 5)()
    _build.load().dfmir_vecint3d_fwd_brick(dims)
    return tuple(dims)


def _bricks3d(shape) -> int:
    """The forward chain's bricks of a (B, 3, D, H, W) field."""
    bz, by, bx = brick3d()[:3]
    B, _, D, H, W = shape
    return B * -(-D // bz) * -(-H // by) * -(-W // bx)


def vecint3d_fwd_cuda(vec: torch.Tensor, nsteps: int, save: bool):
    """``vecint2d_fwd_cuda`` for a 3-D field vec (B, 3, D, H, W): returns
    ``(out, steps)``, ``steps`` the (nsteps, B, 3, D, H, W) stack of
    ``stack3d`` when ``save`` (else None; the launch then keeps two
    ping-pong fields).  Each step reads the field from boxes staged in
    shared memory (``csrc/warp3d.cu``, "THE FORWARD CHAIN")."""
    device = _device(vec, vec, "vecint3d_fwd_cuda", 3)
    out = torch.empty_like(vec)
    if save:
        steps = stack3d(vec, nsteps)
        slot = steps.stride(0)
    else:
        steps = torch.empty_like(vec) if nsteps else None
        slot = vec.numel()
    maxes = torch.empty(_bricks3d(vec.shape), dtype=torch.int32,
                        device=vec.device)
    _launch(VECINT3D_FWD, "dfmir_vecint3d_fwd", device, vec.data_ptr(),
            None if steps is None else steps.data_ptr(), slot,
            out.data_ptr(), maxes.data_ptr(), vec.shape[0], *vec.shape[2:],
            nsteps, int(save), 0)
    return out, steps if save else None


def vecint3d_bwd_cuda(steps: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``vecint2d_bwd_cuda`` for a 3-D field: ``steps`` (nsteps, B, 3, D,
    H, W), each field contiguous (the rows of ``stack3d`` or one contiguous
    stack), ``g`` (B, 3, D, H, W); one launch, bitwise the same on every run
    (its source gradients are binned and summed in a fixed point, as
    ``warp3d_bwd_dsrc_cuda``'s)."""
    device = _device(g, g, "vecint3d_bwd_cuda", 3)
    _check_steps(steps, g, device)
    nsteps = steps.shape[0]
    dvec = torch.empty_like(g)
    scratch = g.new_empty((2, *g.shape)) if nsteps > 1 else None
    bins = _bins3d(g, nsteps)
    _launch(VECINT3D_BWD, "dfmir_vecint3d_bwd", device, steps.data_ptr(),
            steps.stride(0), g.data_ptr(),
            None if scratch is None else scratch.data_ptr(), bins.data_ptr(),
            dvec.data_ptr(), g.shape[0], *g.shape[2:], nsteps, 0)
    return dvec


def _slab_device(src, flow, z0, name) -> int:
    """``_device`` for a 3-D warp whose output may be a slab of the source
    (``_check`` with ``z0``); a whole volume (z0 0, the same D) takes
    ``_device``'s cheap test alone."""
    if z0 == 0 and src.shape[2:] == flow.shape[2:]:
        return _device(src, flow, name, 3)
    _check(src, flow, name, 3, z0)
    return src.get_device()


def warp3d_cuda(src: torch.Tensor, flow: torch.Tensor,
                z0: int = 0) -> torch.Tensor:
    """Launch the 3-D forward kernel: src (B, C, Ds, H, W), flow (B, 3, D,
    H, W), both float32, contiguous and on one CUDA device; returns a fresh
    (B, C, D, H, W), whose plane z samples the source at depth (z + z0) +
    flow_z.  A whole volume: D = Ds, z0 = 0; a slab of a volume split along
    D: the flow's D planes from plane ``z0`` of the whole source.  ``src``
    and ``flow`` may be the same tensor."""
    device = _slab_device(src, flow, z0, "warp3d_cuda")
    out = src.new_empty((*src.shape[:2], *flow.shape[2:]))
    _launch(FWD3D, "dfmir_warp3d_fwd", device, src.data_ptr(),
            flow.data_ptr(), out.data_ptr(), *out.shape, src.shape[2], z0)
    return out


def warp3d_bwd_dflow_cuda(src: torch.Tensor, flow: torch.Tensor,
                          g: torch.Tensor, z0: int = 0) -> torch.Tensor:
    """Launch the 3-D flow-gradient kernel for the cotangent ``g`` (B, C, D,
    H, W) of ``warp3d_cuda(src, flow, z0)``; returns dflow (B, 3, D, H, W),
    summed over channels.  Reproducible from run to run."""
    device = _slab_device(src, flow, z0, "warp3d_bwd_dflow_cuda")
    _check_g(g, src, (*src.shape[:2], *flow.shape[2:]))
    dflow = torch.empty_like(flow)
    _launch(DFLOW3D, "dfmir_warp3d_bwd_dflow", device, src.data_ptr(),
            flow.data_ptr(), g.data_ptr(), dflow.data_ptr(), *g.shape,
            src.shape[2], z0)
    return dflow


def warp3d_bwd_dsrc_cuda(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the 3-D source-gradient kernel for the cotangent ``g`` (B, C,
    D, H, W) of a warp by ``flow``; returns dsrc (B, C, D, H, W).  It needs
    no source values.  Each source voxel gathers the terms of the targets
    that sample it, binned by cell and summed in an int64 fixed point, so
    dsrc is bitwise the same on every run and equal to
    ``ops.warp.warp3d_dsrc_binned_plain(flow, g)``; one cooperative
    launch."""
    device = _device(g, flow, "warp3d_bwd_dsrc_cuda", 3)
    dsrc = torch.empty_like(g)
    bins = _bins3d(g, 1)
    _launch(DSRC3D, "dfmir_warp3d_bwd_dsrc", device, flow.data_ptr(),
            g.data_ptr(), dsrc.data_ptr(), bins.data_ptr(), *g.shape, 0)
    return dsrc


class Warp2dFunction(torch.autograd.Function):
    """The two 2-D kernels behind autograd.  ``backward`` computes the
    source gradient only when ``src`` needs one.  When ``src`` is ``flow``
    (a self-warp), autograd adds the two gradients it returns."""

    @staticmethod
    def forward(ctx, src, flow):
        ctx.save_for_backward(src, flow)
        return warp2d_cuda(src, flow)

    @staticmethod
    def backward(ctx, grad_out):
        src, flow = ctx.saved_tensors
        need_dsrc, need_dflow = ctx.needs_input_grad[:2]
        dsrc, dflow = warp2d_bwd_cuda(src, flow, grad_out.contiguous(),
                                      need_dsrc=need_dsrc)
        return dsrc, dflow if need_dflow else None


class VecInt2dFunction(torch.autograd.Function):
    """VecInt's 2-D chain behind autograd: ``apply(vec, nsteps)``, one launch
    forward and one backward.  The forward saves the fields before each step
    only when ``vec`` needs a gradient; otherwise (inference) it keeps two
    ping-pong buffers and saves nothing."""

    @staticmethod
    def forward(ctx, vec, nsteps):
        out, steps = vecint2d_fwd_cuda(vec, nsteps,
                                       save=ctx.needs_input_grad[0])
        if steps is not None:
            ctx.save_for_backward(steps)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (steps,) = ctx.saved_tensors
        return vecint2d_bwd_cuda(steps, grad_out.contiguous()), None


class VecInt3dFunction(torch.autograd.Function):
    """VecInt's 3-D chain behind autograd, as ``VecInt2dFunction``: one
    launch each way, the steps saved only when ``vec`` needs a gradient."""

    @staticmethod
    def forward(ctx, vec, nsteps):
        out, steps = vecint3d_fwd_cuda(vec, nsteps,
                                       save=ctx.needs_input_grad[0])
        if steps is not None:
            ctx.save_for_backward(steps)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (steps,) = ctx.saved_tensors
        return vecint3d_bwd_cuda(steps, grad_out.contiguous()), None


class Warp3dSlabFunction(torch.autograd.Function):
    """B3 and B4 behind autograd for a slab: ``apply(src, flow, z0)``, the
    output the flow's planes from plane ``z0`` of the whole source
    ``src``.  Only the flow has a gradient: B5 has no slab form, so a
    source that needs one raises."""

    @staticmethod
    def forward(ctx, src, flow, z0):
        if ctx.needs_input_grad[0]:
            raise ValueError("a slab warp's source takes no gradient: B5 "
                             "has no slab form")
        ctx.save_for_backward(src, flow)
        ctx.z0 = z0
        return warp3d_cuda(src, flow, z0)

    @staticmethod
    def backward(ctx, grad_out):
        src, flow = ctx.saved_tensors
        return None, warp3d_bwd_dflow_cuda(src, flow, grad_out.contiguous(),
                                           ctx.z0), None


class Warp3dFunction(torch.autograd.Function):
    """The three 3-D single-warp kernels behind autograd.  ``backward``
    launches the dflow kernel when ``flow`` needs a gradient and the dsrc
    kernel when ``src`` does, so the data warp (a source without a
    gradient) never bins a dsrc.  When ``src`` is ``flow`` (a
    self-warp), both launch and autograd adds the two gradients."""

    @staticmethod
    def forward(ctx, src, flow):
        ctx.save_for_backward(src, flow)
        return warp3d_cuda(src, flow)

    @staticmethod
    def backward(ctx, grad_out):
        src, flow = ctx.saved_tensors
        need_dsrc, need_dflow = ctx.needs_input_grad[:2]
        g = grad_out.contiguous()
        dsrc = warp3d_bwd_dsrc_cuda(flow, g) if need_dsrc else None
        dflow = warp3d_bwd_dflow_cuda(src, flow, g) if need_dflow else None
        return dsrc, dflow
