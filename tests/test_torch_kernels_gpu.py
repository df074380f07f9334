"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA card.  On a machine with one (and no JAX), run:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
Tolerance 1e-5 max-abs: the kernel rounds as the plain version does."""

import pytest
import torch

from dfmir_tpu_torch import infer
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.warp import warp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,scale,shift", [
    ((1, 2, 128, 128), 5.0, 0.0),     # VecInt's self-warp shape
    ((8, 1, 256, 256), 20.0, 0.0),    # full-resolution source warps
    ((2, 1, 64, 64), 40.0, 50.0),     # most pixels sample outside
    ((3, 3, 67, 45), 3.0, 0.0),       # odd shape
])
def test_warp2d_kernel_matches_plain(cuda, shape, scale, shift):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, C, H, W = shape
    src = torch.randn(shape, device=cuda, generator=g)
    flow = torch.randn((B, 2, H, W), device=cuda, generator=g) * scale + shift
    before = warp_cuda.LAUNCHES
    out = warp(src, flow)                         # auto -> the kernel
    assert warp_cuda.LAUNCHES == before + 1
    ref = warp(src, flow, impl="torch")
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5


def test_warp2d_wrapper_refuses(cuda):
    src = torch.zeros(1, 1, 8, 8, device=cuda)
    flow = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        warp_cuda.warp2d_cuda(src.double(), flow.double())
    with pytest.raises(ValueError, match="contiguous"):
        warp_cuda.warp2d_cuda(src.transpose(2, 3), flow)
    with pytest.raises(ValueError, match="does not match"):
        warp_cuda.warp2d_cuda(src, flow[:, :, :4])
    with pytest.raises(NotImplementedError, match="training slice"):
        warp(src.requires_grad_(), flow).sum().backward()


def test_register_launches_eight_warps(cuda):
    cfg = RegistrationConfig(crop_size=64, netG="resnet_4blocks", ngf=8,
                             vxm_enc=(8, 16, 16, 16),
                             vxm_dec=(16, 16, 16, 16, 16, 8, 8))
    gpu = RegistrationModel(cfg)
    cpu = RegistrationModel(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(2, 1, 1, 64, 64, generator=g)
    before = warp_cuda.LAUNCHES
    out = infer.register_pair_outputs(gpu, a.to(cuda), b.to(cuda))
    assert warp_cuda.LAUNCHES == before + 8
    ref = infer.register_pair_outputs(cpu, a, b)
    for k in ("fake_B", "y_source", "pos_flow"):
        assert float((out[k].cpu() - ref[k]).abs().max()) <= 1e-3, k
