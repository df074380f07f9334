"""The Hopper kernel for the 2-D bilinear warp forward.

Replaces the Pallas kernel ``dfmir_tpu/ops/warp_pallas.py::_kernel`` /
``warp2d_banded``.  The kernel is ``csrc/warp2d.cu`` (one thread per output
pixel, see the note there); ``ops/_build.py`` builds it.  Its plain version
is ``ops/warp.py``'s ``warp(..., impl="torch")``, which the CPU tests and
the on-card comparison use.

``LAUNCHES`` counts kernel launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.ops import _build

LAUNCHES = 0


def warp2d_cuda(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: src (B, C, H, W), flow (B, 2, H, W), both float32,
    contiguous and on one CUDA device; returns a fresh (B, C, H, W).

    ``src`` and ``flow`` may be the same tensor (VecInt's self-warp)."""
    global LAUNCHES
    if not (src.is_cuda and flow.is_cuda):
        raise ValueError("warp2d_cuda takes CUDA tensors; on the CPU use "
                         "warp(..., impl='torch')")
    if src.device != flow.device:
        raise ValueError(f"src on {src.device}, flow on {flow.device}")
    if src.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError(f"warp2d_cuda is float32 only, got {src.dtype}, "
                        f"{flow.dtype}")
    if src.ndim != 4 or flow.ndim != 4:
        raise ValueError(f"expected 4-D src and flow, got {tuple(src.shape)} "
                         f"and {tuple(flow.shape)}")
    B, C, H, W = src.shape
    if tuple(flow.shape) != (B, 2, H, W):
        raise ValueError(f"flow shape {tuple(flow.shape)} does not match src "
                         f"{tuple(src.shape)}: expected {(B, 2, H, W)}")
    if not (src.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp2d_cuda takes contiguous tensors")
    if B * C * H * W >= 2 ** 31:
        raise ValueError(f"{tuple(src.shape)} is too large for int sizes")
    out = torch.empty_like(src)
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dfmir_warp2d_fwd(src.data_ptr(), flow.data_ptr(),
                                   out.data_ptr(), B, C, H, W, stream)
    if err != 0:
        raise RuntimeError(f"warp2d kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


class Warp2dFunction(torch.autograd.Function):
    """The kernel behind autograd.  Its backward is the next kernel to port
    (``warp_pallas.py::_bwd_kernel``); until then it raises."""

    @staticmethod
    def forward(ctx, src, flow):
        return warp2d_cuda(src, flow)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the CUDA 2-D warp has no backward kernel yet: it comes with the "
            "training slice (ROADMAP B2)")
