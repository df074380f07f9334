"""``compute_dtype="bfloat16"`` in 2-D: netG and netR on bfloat16 copies
of their float32 parameters, float32 out (netG's output and taps, netR's
flow head), netF, the losses, the flow math and the warps in float32, the
master parameters and Adam's state float32.  Held against the JAX
package's bfloat16 model (never against float32), with the JAX model's
init_state weights carried over by load_jax_params.

The flow head is scaled by BF16_GAIN = 1e4 (max |pos_flow| 0.10 px at this
config): the warps deform, and the field stays below 0.25 px, where one
bfloat16 ulp of the flow head's output is under 1e-3.  Bars, at or under
the JAX suite's own bfloat16-vs-float32 bars
(tests/test_perf_paths.py::TestBf16Compute: fake_B 0.1, pos_flow 1e-3):
- register: fake_B and idt_B 0.1 max-abs (measured 2.8e-3 / 3.2e-3),
  pos_flow 1e-3 (8.2e-4), y_source 1e-2 (1.3e-3);
- loss_fn metrics: 1e-2 relative (measured at most 2.5e-3, NCE; JAX's
  own bfloat16 is 8.4e-3 from its float32 on NCE_Y).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import load_jax_params, to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.ops import integrate
from dfmir_tpu_torch.ops import warp as warp_mod
from test_torch_train import CFG, KEY, LR, jax_patch_ids, tap_locations
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

BF16 = dict(CFG, compute_dtype="bfloat16")
BF16_GAIN = 1e4
REGISTER_BARS = {"fake_B": 0.1, "idt_B": 0.1, "y_source": 1e-2,
                 "pos_flow": 1e-3}
METRIC_BAR = 1e-2


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(JaxConfig(**BF16))
    params = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                          jm.init_state(jax.random.PRNGKey(0)).params)
    params["R"]["flow"]["kernel"] *= BF16_GAIN
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((2, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    A, Bt = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**BF16), device="cpu")
        load_jax_params(tm, params)
        return tm

    ids = jax_patch_ids(KEY, tap_locations(port_model(), A),
                        CFG["num_patches"])
    return dict(jm=jm, jp=jax.tree.map(jnp.asarray, params), a=a, b=b,
                A=A, B=Bt, ids=ids, port_model=port_model)


def test_register_matches_jax_bf16(setup):
    s = setup
    ref = s["jm"].register(s["jp"], jnp.asarray(s["a"]), jnp.asarray(s["b"]))
    out = s["port_model"]().register(s["A"], s["B"])
    assert 0.05 < float(out[3].abs().max()) < 0.25      # it deforms
    for name, o, r in zip(REGISTER_BARS, out, ref):
        assert o.dtype == torch.float32, name
        err = float(np.abs(to_nhwc(o) - np.asarray(r)).max())
        assert err <= REGISTER_BARS[name], (name, err)


def test_loss_fn_matches_jax_bf16(setup):
    s = setup
    _, (ref, jaux) = jax.jit(lambda p: s["jm"]._loss_fn(
        p, jnp.asarray(s["a"]), jnp.asarray(s["b"]), KEY))(s["jp"])
    tm = s["port_model"]()
    with torch.no_grad():
        _, metrics, aux = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    assert set(metrics) == set(ref)
    for k, v in metrics.items():
        r = float(ref[k])
        assert abs(float(v) - r) <= METRIC_BAR * abs(r), (k, float(v), r)
    for k, v in aux.items():
        assert v.dtype == torch.float32, k
    np.testing.assert_allclose(to_nhwc(aux["pos_flow"]),
                               np.asarray(jaux["pos_flow"]), rtol=0,
                               atol=REGISTER_BARS["pos_flow"])


def test_bf16_differs_from_float32(setup):
    """The bf16 model computes something else than the float32 one on the
    same weights (the casts are live)."""
    s = setup
    tm = s["port_model"]()
    f32 = RegistrationModel(RegistrationConfig(**CFG), device="cpu")
    f32.netG.load_state_dict(tm.netG.state_dict())
    f32.netR.load_state_dict(tm.netR.state_dict())
    a, b = tm.register(s["A"], s["B"]), f32.register(s["A"], s["B"])
    assert not torch.equal(a[0], b[0])
    assert float((a[0] - b[0]).abs().max()) < REGISTER_BARS["fake_B"]


def test_step_dtypes_and_warps_fed_float32(setup, counted_kernels,
                                           monkeypatch):
    """One bf16 train step: finite, master parameters and Adam's moments
    float32, every warp and VecInt chain handed float32 (the kernels are
    float32 only), and the CUT step's launches."""
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
    assert counted_kernels == dict(counted_kernels, vecint2d_fwd=1,
                                   warp2d_bilinear_fwd=2, vecint2d_bwd=1,
                                   warp2d_bilinear_bwd=2)
    for p in tm.parameters():
        assert p.dtype == torch.float32
    for st in tm.optimizer.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    for net in (tm.netG, tm.netR):
        assert any(p.grad is not None and p.grad.dtype == torch.float32
                   for p in net.parameters())


def test_register_launches(setup, counted_kernels):
    tm = setup["port_model"]()
    tm.register(setup["A"], setup["B"])
    assert counted_kernels == dict(counted_kernels, vecint2d_fwd=1,
                                   warp2d_bilinear_fwd=1)
    assert sum(counted_kernels.values()) == 2


def test_bfloat16_raises_at_3d():
    """bfloat16 at ndims=3 is ported (tests/test_torch_joint3d_bf16.py);
    a compute dtype other than float32 or bfloat16 is refused."""
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        RegistrationModel(RegistrationConfig(**dict(CFG,
                                                    compute_dtype="half")),
                          device="cpu")
