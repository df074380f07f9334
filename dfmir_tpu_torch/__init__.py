"""PyTorch/CUDA port of dfmir_tpu (DFMIR: translate-then-register).

Module names mirror ``dfmir_tpu/`` one for one.  Tensors are NCHW; flow
channel ``i`` is the pixel displacement along spatial axis ``i``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``
(see ``dfmir_tpu_torch.device``).  The only hand-written kernel so far is
the 2-D bilinear warp forward (``ops/warp_cuda.py``, ``csrc/warp2d.cu``).
"""
