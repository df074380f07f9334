"""The 3-D ``VxmEngine`` on slabs whose deepest UNet level does not split:
a 32^3 volume, enc (8, 8, 8, 8), over 1 x 4 ``gloo`` ranks on the CPU.
netR's levels hold 8, 4, 2 and 1 planes a rank, and the fourth encoder
level (2 planes in all) runs on the gathered map, as ``VxmConfig()`` at
160^3 over 4 ranks gathers its fourth (10 planes).  Against the JAX
engine's single-device ``register``, ``eval_step``, ``flow_stats`` and
``train_step`` on the whole batch (global B=2), from the JAX weights with
the flow head scaled by ``GAIN`` (``test_torch_spatial_train.py``'s).

Bars: ``register`` 1e-5 max-abs (JAX's own for a sharded register,
``tests/test_vxm3d.py``); metrics and statistics 1e-5 relative (the
engine's spatial tests'); netR's gradients within 1e-3 of its max |g|
(JAX's from its Adam state: mu = 0.1 g); the parameters after the step
atol 1e-5, rtol 1e-4; every rank's parameters and Adam state bit-equal.
One launch of 4 ranks, in a thread beside the JAX compiles."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.vxm_engine import VxmConfig as JaxVxmConfig
from dfmir_tpu.engine.vxm_engine import VxmEngine as JaxVxmEngine
from dfmir_tpu.engine.vxm_engine import VxmState
from dfmir_tpu_torch.compat.convert import (load_jax_vxm_params,
                                            netR_state_from_jax, to_nchw,
                                            to_nhwc)
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.parallel.mesh import check_joint_slabs
from test_torch_spatial_train import scaled_params
from test_torch_spatial_vxm import assembled
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

B = 2
CFG = dict(ndims=3, vol_size=32, enc=(8, 8, 8, 8), dec=(8, 8, 8, 8, 8, 8),
           int_steps=3, batch_size=B, image_loss="ncc")
N_SPATIAL = 4
LIMIT = 300.0


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    a, b = (rng.random((B, 32, 32, 32, 1)).astype(np.float32)
            for _ in range(2))
    batch = (torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b)))
    jeng = JaxVxmEngine(JaxVxmConfig(**CFG))
    params = scaled_params(jeng)
    port = VxmEngine(VxmConfig(**CFG), device="cpu")
    load_jax_vxm_params(port, params)
    start = {k: v.clone() for k, v in port.netR.state_dict().items()}
    job = dict(cfg=CFG, n_data=1, n_spatial=N_SPATIAL, state={"R": start},
               batches=[batch], register=batch, eval=True, stats=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4,
                         ([("deep", "vxm_spatial_steps", {"job": job})],),
                         LIMIT)
    jp = jax.tree.map(jnp.asarray, params)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    out = {"future": future, "start": start,
           "register": [np.asarray(x) for x in jeng.register(jp, ja, jb)],
           "eval": {k: float(v) for k, v in jeng.eval_step(jp, ja,
                                                           jb).items()},
           "stats": {k: float(v) for k, v in jeng.flow_stats(jp, ja,
                                                             jb).items()}}
    state = VxmState(params=jax.tree.map(jnp.copy, jp),
                     opt_state=jeng.tx.init(jp),
                     step=jnp.zeros((), jnp.int32))
    st, metrics = jeng.train_step(state, ja, jb)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = netR_state_from_jax(jax.tree.map(
        lambda m: 10.0 * np.asarray(m), st.opt_state.mu), CFG["enc"],
        CFG["dec"])
    want = VxmEngine(VxmConfig(**CFG), device="cpu")
    load_jax_vxm_params(want, jax.tree.map(np.asarray, st.params))
    out["params"] = {k: p.detach() for k, p in want.netR.named_parameters()}
    yield out
    pool.shutdown(wait=True)


def reports(setup):
    ranks = setup["future"].result(timeout=LIMIT + 60)
    reps = [r["deep"] for r in ranks if r["deep"].get("in_mesh", True)]
    assert len(reps) == N_SPATIAL
    return reps


def test_the_fourth_level_is_gathered():
    for cfg, depth in ((VxmConfig(**CFG), 32), (VxmConfig(), 160)):
        assert check_joint_slabs(depth, N_SPATIAL, len(cfg.enc),
                                 cfg.int_downsize) == 4


def test_register_matches_jax(setup):
    reps = reports(setup)
    assert float(np.abs(setup["register"][1]).max()) > 0.5
    for i, ref in enumerate(setup["register"]):
        np.testing.assert_allclose(to_nhwc(assembled(reps, i)), ref, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("what", ["eval", "stats"])
def test_eval_and_stats_match_jax(setup, what):
    for r in reports(setup):
        for k, ref in setup[what].items():
            got = float(r[what][k])
            assert abs(got - ref) <= 1e-5 * abs(ref) + 1e-7, (k, got, ref)


def test_train_step_matches_jax(setup):
    """The step's metrics and gradients JAX's, the parameters after it
    JAX's, every rank's state bit-equal."""
    reps = reports(setup)
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
    for k, ref in setup["metrics"].items():
        got = reps[0]["metrics"][0][k]
        assert abs(got - ref) <= 1e-5 * abs(ref), (k, got, ref)
    rank0, = [r for r in reps if r["rank"] == 0]
    scale = max(float(g.abs().max()) for g in setup["grads"].values())
    for k, g in setup["grads"].items():
        err = float((rank0["grads"]["R"][k] - g).abs().max())
        assert err <= 1e-3 * scale, (k, err, scale)
    moved = False
    for k, p in setup["params"].items():
        mine = rank0["params"]["R"][k]
        np.testing.assert_allclose(mine.numpy(), p.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
        moved |= not torch.equal(mine, setup["start"][k])
    assert moved
