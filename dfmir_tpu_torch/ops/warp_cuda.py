"""The Hopper kernels for the 2-D bilinear and 3-D trilinear warps, forward
and backward.

Each launcher replaces a Pallas kernel of ``dfmir_tpu/ops/warp_pallas.py``:

- ``warp2d_cuda``: ``_kernel`` / ``warp2d_banded`` (``csrc/warp2d.cu``);
- ``warp2d_bwd_cuda``: ``_bwd_kernel`` / ``warp2d_banded_bwd`` (both
  gradients, one launch);
- ``warp3d_cuda``: ``_kernel3d`` / ``warp3d_banded`` (``csrc/warp3d.cu``);
- ``warp3d_bwd_dflow_cuda``: ``_bwd_kernel3d_dflow`` /
  ``warp3d_banded_bwd_dflow``;
- ``warp3d_bwd_dsrc_cuda``: ``_bwd_kernel3d_dsrc`` /
  ``warp3d_banded_bwd_dsrc``.

All are one thread per output pixel or voxel (see the notes in the
sources); ``ops/_build.py`` builds them.  Their plain versions are
``ops/warp.py``'s ``warp(..., impl="torch")`` and ``warp_bwd_plain``, which
the CPU tests and the on-card comparison use.  ``Warp2dFunction`` and
``Warp3dFunction`` tie each warp's kernels together for autograd, as the
custom VJPs ``_warp2d`` / ``_warp3d`` do in the JAX package.

``LAUNCHES`` counts the launches of each kernel by name, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import math

import torch

from dfmir_tpu_torch.ops import _build

FWD = "warp2d_bilinear_fwd"
BWD = "warp2d_bilinear_bwd"
FWD3D = "warp3d_trilinear_fwd"
DFLOW3D = "warp3d_trilinear_bwd_dflow"
DSRC3D = "warp3d_trilinear_bwd_dsrc"
LAUNCHES = {FWD: 0, BWD: 0, FWD3D: 0, DFLOW3D: 0, DSRC3D: 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(src, flow, name, nd):
    """Raise unless src (B, C, *S) and flow (B, nd, *S), with ``nd`` spatial
    axes, are float32, contiguous and on one CUDA device."""
    if not (src.is_cuda and flow.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors; on the CPU use "
                         f"warp(..., impl='torch')")
    if src.device != flow.device:
        raise ValueError(f"src on {src.device}, flow on {flow.device}")
    if src.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"{name} is float32 only, got {src.dtype}, "
                        f"{flow.dtype}")
    if src.ndim != nd + 2 or flow.ndim != nd + 2:
        raise ValueError(f"expected {nd + 2}-D src and flow, got "
                         f"{tuple(src.shape)} and {tuple(flow.shape)}")
    B, C, *spatial = src.shape
    if tuple(flow.shape) != (B, nd, *spatial):
        raise ValueError(f"flow shape {tuple(flow.shape)} does not match src "
                         f"{tuple(src.shape)}: expected {(B, nd, *spatial)}")
    if not (src.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if B * max(C, nd) * math.prod(spatial) >= 2 ** 31:
        raise ValueError(f"{tuple(src.shape)} is too large for int sizes")


def _check_g(g, like):
    """Raise unless the cotangent ``g`` is float32, contiguous, of ``like``'s
    shape and on its device."""
    if g.device != like.device or g.dtype != torch.float32:
        raise TypeError(f"g must be float32 on {like.device}, got {g.dtype} "
                        f"on {g.device}")
    if g.shape != like.shape or not g.is_contiguous():
        raise ValueError(f"g must be contiguous and of src's shape "
                         f"{tuple(like.shape)}, got {tuple(g.shape)}")


def _launch(name, entry, device, *args):
    """Call the library's ``entry`` on ``device``'s current stream, raise on
    a refused launch, count it."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def warp2d_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: src (B, C, H, W), flow (B, 2, H, W), both
    float32, contiguous and on one CUDA device; returns a fresh (B, C, H, W).

    ``src`` and ``flow`` may be the same tensor (VecInt's self-warp)."""
    _check(src, flow, "warp2d_cuda", 2)
    out = torch.empty_like(src)
    _launch(FWD, "dfmir_warp2d_fwd", src.device, src.data_ptr(),
            flow.data_ptr(), out.data_ptr(), *src.shape)
    return out


def warp2d_bwd_cuda(src: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                    need_dsrc: bool = True):
    """Launch the backward kernel for the cotangent ``g`` (B, C, H, W) of
    ``warp2d_cuda(src, flow)``; returns ``(dsrc, dflow)``, with ``dsrc``
    None unless ``need_dsrc`` (the scatter and its zero-fill are skipped).

    ``dsrc`` is summed with float32 atomics, so it is not bitwise
    reproducible from run to run; ``dflow`` is."""
    _check(src, flow, "warp2d_bwd_cuda", 2)
    _check_g(g, src)
    dflow = torch.empty_like(flow)
    dsrc = torch.zeros_like(src) if need_dsrc else None
    _launch(BWD, "dfmir_warp2d_bwd", src.device, src.data_ptr(),
            flow.data_ptr(), g.data_ptr(),
            dsrc.data_ptr() if need_dsrc else None, dflow.data_ptr(),
            *src.shape)
    return dsrc, dflow


def warp3d_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the 3-D forward kernel: src (B, C, D, H, W), flow (B, 3, D, H,
    W), both float32, contiguous and on one CUDA device; returns a fresh
    (B, C, D, H, W).  ``src`` and ``flow`` may be the same tensor."""
    _check(src, flow, "warp3d_cuda", 3)
    out = torch.empty_like(src)
    _launch(FWD3D, "dfmir_warp3d_fwd", src.device, src.data_ptr(),
            flow.data_ptr(), out.data_ptr(), *src.shape)
    return out


def warp3d_bwd_dflow_cuda(src: torch.Tensor, flow: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """Launch the 3-D flow-gradient kernel for the cotangent ``g`` (B, C, D,
    H, W) of ``warp3d_cuda(src, flow)``; returns dflow (B, 3, D, H, W),
    summed over channels.  Reproducible from run to run."""
    _check(src, flow, "warp3d_bwd_dflow_cuda", 3)
    _check_g(g, src)
    dflow = torch.empty_like(flow)
    _launch(DFLOW3D, "dfmir_warp3d_bwd_dflow", src.device, src.data_ptr(),
            flow.data_ptr(), g.data_ptr(), dflow.data_ptr(), *src.shape)
    return dflow


def warp3d_bwd_dsrc_cuda(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the 3-D source-gradient kernel for the cotangent ``g`` (B, C,
    D, H, W) of a warp by ``flow``; returns dsrc (B, C, D, H, W).  It needs
    no source values.  dsrc is summed with float32 atomics into a zeroed
    buffer, so it is not bitwise reproducible from run to run."""
    _check(g, flow, "warp3d_bwd_dsrc_cuda", 3)
    dsrc = torch.zeros_like(g)
    _launch(DSRC3D, "dfmir_warp3d_bwd_dsrc", g.device, flow.data_ptr(),
            g.data_ptr(), dsrc.data_ptr(), *g.shape)
    return dsrc


class Warp2dFunction(torch.autograd.Function):
    """The two 2-D kernels behind autograd.  ``backward`` computes the
    source gradient only when ``src`` needs one.  When ``src`` is ``flow``
    (VecInt), autograd adds the two gradients it returns."""

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


class Warp3dFunction(torch.autograd.Function):
    """The three 3-D kernels behind autograd.  ``backward`` launches the
    dflow kernel when ``flow`` needs a gradient and the dsrc kernel when
    ``src`` does, so the data warp (a source without a gradient) never
    scatters or zero-fills a dsrc.  When ``src`` is ``flow`` (VecInt), both
    launch and autograd adds the two gradients."""

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
