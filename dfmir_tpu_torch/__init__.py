"""PyTorch/CUDA port of dfmir_tpu (DFMIR: translate-then-register).

Module names mirror ``dfmir_tpu/`` one for one.  Tensors are NCHW; flow
channel ``i`` is the pixel displacement along spatial axis ``i``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``
(see ``dfmir_tpu_torch.device``).  The hand-written kernels
(``ops/warp_cuda.py``, ``csrc/*.cu``) are the 2-D bilinear and 3-D
trilinear warps, forward and backward, and VecInt's 2-D chain.
"""
