"""PyTorch/CUDA port of dfmir_tpu (DFMIR: translate-then-register).

Module names mirror ``dfmir_tpu/`` one for one.  Tensors are NCHW; flow
channel ``i`` is the pixel displacement along spatial axis ``i``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``
(see ``dfmir_tpu_torch.device``).  The hand-written kernels so far are
the 2-D bilinear warp's forward and backward (``ops/warp_cuda.py``,
``csrc/warp2d.cu``).
"""
