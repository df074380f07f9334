"""The Hopper kernels for the 2-D bilinear warp, forward and backward.

``warp2d_cuda`` replaces the Pallas kernel
``dfmir_tpu/ops/warp_pallas.py::_kernel`` / ``warp2d_banded``;
``warp2d_bwd_cuda`` replaces ``_bwd_kernel`` / ``warp2d_banded_bwd``.  Both
are ``csrc/warp2d.cu`` (one thread per output pixel, see the notes there);
``ops/_build.py`` builds them.  Their plain versions are ``ops/warp.py``'s
``warp(..., impl="torch")`` and ``warp2d_bwd_plain``, which the CPU tests
and the on-card comparison use.  ``Warp2dFunction`` ties the two kernels
together for autograd, as ``_warp2d``'s custom VJP does in the JAX package.

``LAUNCHES`` counts the launches of each kernel by name, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.ops import _build

FWD = "warp2d_bilinear_fwd"
BWD = "warp2d_bilinear_bwd"
LAUNCHES = {FWD: 0, BWD: 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(src, flow, name):
    """Raise unless src (B, C, H, W) and flow (B, 2, H, W) are float32,
    contiguous and on one CUDA device."""
    if not (src.is_cuda and flow.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors; on the CPU use "
                         f"warp(..., impl='torch')")
    if src.device != flow.device:
        raise ValueError(f"src on {src.device}, flow on {flow.device}")
    if src.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"{name} is float32 only, got {src.dtype}, "
                        f"{flow.dtype}")
    if src.ndim != 4 or flow.ndim != 4:
        raise ValueError(f"expected 4-D src and flow, got {tuple(src.shape)} "
                         f"and {tuple(flow.shape)}")
    B, C, H, W = src.shape
    if tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"flow shape {tuple(flow.shape)} does not match src "
                         f"{tuple(src.shape)}: expected {(B, 2, H, W)}")
    if not (src.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if B * max(C, 2) * H * W >= 2 ** 31:
        raise ValueError(f"{tuple(src.shape)} is too large for int sizes")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def warp2d_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: src (B, C, H, W), flow (B, 2, H, W), both
    float32, contiguous and on one CUDA device; returns a fresh (B, C, H, W).

    ``src`` and ``flow`` may be the same tensor (VecInt's self-warp)."""
    _check(src, flow, "warp2d_cuda")
    B, C, H, W = src.shape
    out = torch.empty_like(src)
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dfmir_warp2d_fwd(src.data_ptr(), flow.data_ptr(),
                                   out.data_ptr(), B, C, H, W, stream)
    _raise_on(err, FWD)
    LAUNCHES[FWD] += 1
    return out


def warp2d_bwd_cuda(src: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                    need_dsrc: bool = True):
    """Launch the backward kernel for the cotangent ``g`` (B, C, H, W) of
    ``warp2d_cuda(src, flow)``; returns ``(dsrc, dflow)``, with ``dsrc``
    None unless ``need_dsrc`` (the scatter and its zero-fill are skipped).

    ``dsrc`` is summed with float32 atomics, so it is not bitwise
    reproducible from run to run; ``dflow`` is."""
    _check(src, flow, "warp2d_bwd_cuda")
    if g.device != src.device or g.dtype != torch.float32:
        raise TypeError(f"g must be float32 on {src.device}, got {g.dtype} "
                        f"on {g.device}")
    if g.shape != src.shape or not g.is_contiguous():
        raise ValueError(f"g must be contiguous and of src's shape "
                         f"{tuple(src.shape)}, got {tuple(g.shape)}")
    B, C, H, W = src.shape
    dflow = torch.empty_like(flow)
    dsrc = torch.zeros_like(src) if need_dsrc else None
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dfmir_warp2d_bwd(
            src.data_ptr(), flow.data_ptr(), g.data_ptr(),
            dsrc.data_ptr() if need_dsrc else None, dflow.data_ptr(),
            B, C, H, W, stream)
    _raise_on(err, BWD)
    LAUNCHES[BWD] += 1
    return dsrc, dflow


class Warp2dFunction(torch.autograd.Function):
    """The two kernels behind autograd.  ``backward`` computes the source
    gradient only when ``src`` needs one.  When ``src`` is ``flow``
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
