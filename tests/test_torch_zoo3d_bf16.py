"""The 3-D zoo in bfloat16: for each choice of ``test_torch_zoo3d_*``
alone (netG unet shallowed to 4 levels, netF global_pool and
strided_conv, netR vxm_dual, netD n_layers and pixel), the port's
``register`` at ``ndims=3, compute_dtype="bfloat16"`` against the JAX
package's bfloat16 ``register`` on the same weights (the port's initial
ones, the flow head times BF16_GAIN: about 0.1 voxel), at
``test_torch_joint3d_bf16.py``'s bars (fake_B and idt_B 0.1 max-abs,
y_source 1e-2, pos_flow 1e-3); then one bfloat16 train step: finite,
the 3-D joint step's launches, master parameters and both Adams' moments
float32.

``register`` reads netG and netR only, so the choices that keep both
(the netF and netD ones) share one JAX compile: the port draws netG and
netR first, so their weights are the same, which the test checks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from test_torch_bf16 import REGISTER_BARS
from test_torch_joint3d import CFG3D, STEP3D, volumes
from test_torch_joint3d_bf16 import BF16_GAIN
from test_torch_train import LR
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo3d_train import (STRIDED_LAYERS, jax_model, jax_params,
                                    shallow_unet)
from test_torch_zoo_train import GAN
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

CHOICES = {
    "netG_unet": dict(netG="unet_128", nce_layers=(0, 1, 2, 3)),
    "netF_global_pool": dict(netF="global_pool"),
    "netF_strided_conv": dict(netF="strided_conv",
                              nce_layers=STRIDED_LAYERS),
    "netR_vxm_dual": dict(netR="vxm_dual"),
    "netD_n_layers": dict(netD="n_layers", n_layers_D=2, **GAN),
    "netD_pixel": dict(netD="pixel", **GAN),
}


@pytest.fixture(scope="module")
def jax_registers():
    """JAX's bf16 register outputs by (netG, netR), with the port's netG
    and netR weights they were computed from."""
    return {}


def port_model(cfg):
    with shallow_unet(cfg):
        tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        tm.netR.flow.weight.mul_(BF16_GAIN)
    return tm


@pytest.mark.parametrize("choice", list(CHOICES))
def test_register_and_step_bf16_3d(choice, jax_registers, counted_kernels):
    cfg = dict(CFG3D, compute_dtype="bfloat16", **CHOICES[choice])
    tm = port_model(cfg)
    a, b = volumes(0)
    A, B = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))
    key = (cfg.get("netG", CFG3D["netG"]), cfg.get("netR", "vxm"))
    weights = {f"{net}.{k}": v.clone() for net in ("netG", "netR")
               for k, v in getattr(tm, net).state_dict().items()}
    if key not in jax_registers:
        jm = jax_model(cfg)
        shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
        params = jax.tree.map(jnp.asarray, jax_params(cfg, tm, shapes))
        jax_registers[key] = (weights, [np.asarray(o) for o in jm.register(
            {k: params[k] for k in "GR"}, jnp.asarray(a), jnp.asarray(b))])
    shared, ref = jax_registers[key]
    assert all(torch.equal(v, shared[k]) for k, v in weights.items())
    out = tm.register(A, B)
    assert 0.03 < float(out[3].abs().max()) < 0.15      # it deforms
    for name, o, r in zip(REGISTER_BARS, out, ref):
        assert o.dtype == torch.float32, name
        err = float(np.abs(to_nhwc(o) - r).max())
        assert err <= REGISTER_BARS[name], (name, err)

    for k in counted_kernels:
        counted_kernels[k] = 0
    m = tm.train_step(A, B, LR, generator=torch.Generator().manual_seed(1))
    assert all(math.isfinite(float(v)) for v in m.values())
    assert counted_kernels == dict(counted_kernels, **STEP3D)
    assert sum(counted_kernels.values()) == sum(STEP3D.values())
    opts = [tm.optimizer] + ([tm.optimizer_D] if tm.netD is not None
                             else [])
    assert all(p.dtype == torch.float32 for o in opts
               for g in o.param_groups for p in g["params"])
    assert all(st["exp_avg"].dtype == st["exp_avg_sq"].dtype
               == torch.float32 for o in opts for st in o.state.values())
    assert (tm.netD is not None) == ("netD" in choice)
