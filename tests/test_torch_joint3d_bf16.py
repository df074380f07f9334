"""The joint model in 3-D in bfloat16: the port's RegistrationModel at
``ndims=3, compute_dtype="bfloat16"`` against the JAX package's bfloat16
RegistrationModel(ndims=3) (never against float32), from the same
weights and the patch ids its step draws (``test_torch_joint3d.py``'s
config and ``make_setup``; JAX's ``register`` and ``_loss_fn`` compiled
once, neither with a gradient).

As in 2-D, netG and netR run on bfloat16 copies of their float32
parameters with bfloat16 inputs; the 3-D VxmDense hands its flow head's
output back in float32, and the resize, the integration and the warps
stay float32, as JAX's (``dfmir_tpu/nets/vxm.py``: the UNet in the
compute dtype, the flow head ``.astype(jnp.float32)``).

The flow head is scaled by BF16_GAIN (max |pos_flow| about 0.1 voxel):
the warps deform, and one bfloat16 ulp of the flow head's output stays
under the pos_flow bar.  Bars (test_torch_bf16.py's): fake_B and idt_B
0.1 max-abs, pos_flow 1e-3, y_source 1e-2; metrics 1e-2 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfmir_tpu_torch.compat.convert import to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.ops import integrate
from dfmir_tpu_torch.ops import warp as warp_mod
from test_torch_bf16 import METRIC_BAR, REGISTER_BARS
from torch_threads import few_threads  # noqa: F401 (autouse fixture)
from test_torch_joint3d import CFG3D, STEP3D, make_setup
from test_torch_train import KEY, LR
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)

BF16_3D = dict(CFG3D, compute_dtype="bfloat16")
BF16_GAIN = 8e3


@pytest.fixture(scope="module")
def setup():
    s = make_setup(BF16_3D, BF16_GAIN, jax_step=False)
    _, (metrics, aux) = jax.jit(lambda p: s["jm"]._loss_fn(
        p, jnp.asarray(s["a"]), jnp.asarray(s["b"]), KEY))(s["jp"])
    s.update(metrics={k: float(v) for k, v in metrics.items()},
             pos_flow=np.asarray(aux["pos_flow"]))
    return s


def test_register_matches_jax_bf16_3d(setup):
    s = setup
    out = s["port_model"]().register(s["A"], s["B"])
    assert 0.03 < float(out[3].abs().max()) < 0.15      # it deforms
    for name, o, r in zip(REGISTER_BARS, out, s["register"]):
        assert o.dtype == torch.float32, name
        err = float(np.abs(to_nhwc(o) - r).max())
        assert err <= REGISTER_BARS[name], (name, err)


def test_loss_fn_matches_jax_bf16_3d(setup):
    s = setup
    tm = s["port_model"]()
    with torch.no_grad():
        _, metrics, aux = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    assert set(metrics) == set(s["metrics"])
    for k, v in metrics.items():
        r = s["metrics"][k]
        assert abs(float(v) - r) <= METRIC_BAR * abs(r), (k, float(v), r)
    for k, v in aux.items():
        assert v.dtype == torch.float32, k
    np.testing.assert_allclose(to_nhwc(aux["pos_flow"]), s["pos_flow"],
                               rtol=0, atol=REGISTER_BARS["pos_flow"])


def test_bf16_3d_differs_from_float32(setup):
    """The casts are live at 3-D: the bf16 model's fake_B is not the
    float32 model's on the same weights, and within the bar of it."""
    s = setup
    tm = s["port_model"]()
    f32 = RegistrationModel(RegistrationConfig(**CFG3D), device="cpu")
    f32.netG.load_state_dict(tm.netG.state_dict())
    f32.netR.load_state_dict(tm.netR.state_dict())
    a, b = tm.register(s["A"], s["B"]), f32.register(s["A"], s["B"])
    assert not torch.equal(a[0], b[0])
    assert float((a[0] - b[0]).abs().max()) < REGISTER_BARS["fake_B"]


def test_step_3d_dtypes(setup, counted_kernels, monkeypatch):
    """One bf16 3-D train step: finite, master parameters and Adam's
    moments float32, every warp and chain handed float32, and the 3-D
    joint step's launches (B5 among them)."""
    s = setup
    seen = []
    takes, chain_takes = warp_mod._kernel_takes, integrate._chain_takes

    def record(src, flow, mode):
        seen.append((src.dtype, flow.dtype))
        return takes(src, flow, mode)

    def record_chain(vec):
        seen.append((vec.dtype,))
        return chain_takes(vec)

    monkeypatch.setattr(warp_mod, "_kernel_takes", record)
    monkeypatch.setattr(integrate, "_chain_takes", record_chain)
    tm = s["port_model"]()
    m = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"])
    assert all(math.isfinite(float(v)) for v in m.values())
    assert seen and all(d == torch.float32 for ds in seen for d in ds), seen
    assert counted_kernels == dict(counted_kernels, **STEP3D)
    for p in tm.parameters():
        assert p.dtype == torch.float32
    for st in tm.optimizer.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    for net in (tm.netG, tm.netR):
        assert any(p.grad is not None and p.grad.dtype == torch.float32
                   for p in net.parameters())
