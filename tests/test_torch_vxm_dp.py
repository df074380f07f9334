"""The 3-D ``VxmEngine`` step data parallel (parallel/) over 2 ``gloo``
ranks on the CPU, global B=4, 2 a rank, against the JAX engine's
single-device ``train_step`` on the whole batch, at tests/test_vxm3d.py's
sharded config (vol 16, enc (4, 8), dec (8, 4, 4), 3 integration steps)
with both image losses, the JAX weights carried over.  JAX's own bars
(tests/test_vxm3d.py's sharded tests): total 1e-5 relative, parameters
after the step atol 1e-5, rtol 1e-4.  NCC's ``-sqrt`` of a batch mean is
not a mean of the ranks' losses: the step reduces its mean over the global
batch first (``parallel.mesh.global_mean``).  The ranks hold their
parameters and Adam state bit for bit alike after the step."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.vxm_engine import VxmConfig as JaxVxmConfig
from dfmir_tpu.engine.vxm_engine import VxmEngine as JaxVxmEngine
from dfmir_tpu_torch.compat.convert import load_jax_vxm_params, to_nchw
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_cli import few_threads  # noqa: F401 (autouse fixture)

B = 4
CFG = dict(ndims=3, vol_size=16, enc=(4, 8), dec=(8, 4, 4), int_steps=3,
           batch_size=B)
LOSSES = ("mse", "ncc")
LIMIT = 300.0


@pytest.fixture(scope="module")
def setup():
    """JAX engines and weights, the volumes, and the launch of both
    losses' steps, started in a thread beside the JAX compiles."""
    rng = np.random.default_rng(0)
    a, b = (rng.random((B, 16, 16, 16, 1)).astype(np.float32)
            for _ in range(2))
    out = {"a": a, "b": b}
    cases = []
    for loss in LOSSES:
        jeng = JaxVxmEngine(JaxVxmConfig(**CFG, image_loss=loss))
        state = jeng.init_state(jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, state.params)
        eng = VxmEngine(VxmConfig(**CFG, image_loss=loss), device="cpu")
        load_jax_vxm_params(eng, params)
        out[loss] = dict(jeng=jeng, state=state, port=eng)
        cases.append((loss, "vxm_steps", {"job": dict(
            cfg=dict(CFG, image_loss=loss),
            state={"R": eng.netR.state_dict()},
            batches=[(torch.from_numpy(to_nchw(a)),
                      torch.from_numpy(to_nchw(b)))])}))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    out["future"] = pool.submit(launch, checks.run_cases, ["cpu", "cpu"],
                                (cases,), LIMIT)
    yield out
    pool.shutdown(wait=True)


@pytest.mark.parametrize("loss", LOSSES)
def test_step_matches_jax_single_device(setup, loss):
    s = setup[loss]
    st, jmetrics = s["jeng"].train_step(s["state"], jnp.asarray(setup["a"]),
                                        jnp.asarray(setup["b"]))
    want = VxmEngine(VxmConfig(**CFG, image_loss=loss), device="cpu")
    load_jax_vxm_params(want, jax.tree.map(np.asarray, st.params))
    rep = [r[loss] for r in setup["future"].result(timeout=LIMIT + 60)]
    assert torch.equal(rep[0]["checksums"][0], rep[1]["checksums"][0])
    total, ref = rep[0]["metrics"][0]["total"], float(jmetrics["total"])
    assert abs(total - ref) <= 1e-5 * abs(ref), (total, ref)
    moved = False
    for name, p in want.netR.named_parameters():
        mine = rep[0]["params"]["R"][name]
        np.testing.assert_allclose(mine.numpy(), p.detach().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        moved |= not torch.equal(mine, s["port"].netR.state_dict()[name])
    assert moved
