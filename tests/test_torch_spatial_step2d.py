"""The joint model's 2-D step with its images split along H (JAX's
``spatial`` mesh axis) over ``gloo`` ranks on the CPU, against the JAX
RegistrationModel on the whole batch, from the same weights (the port's
initial ones through JAX's converters, the flow head times
``FLOW_GAIN``) and the patch ids the JAX step draws:

- crop 32, ngf 8, vxm_enc (8, 16) on 1 x 2 and 1 x 4 meshes at B=2: one
  ``loss_fn`` (metrics, and the gradients averaged over the ranks),
  ``eval_step`` and one ``train_step``, against the metrics and gradients
  of JAX's ``train_step`` (its ``_loss_fn``'s; g = 2 mu at beta1 0.5);
- the graft's shape at narrow widths (crop 64, netR six levels of width
  8, 64 patches, ngf 8) on 1 x 2: netR's sixth level (1 row) does not
  split and runs gathered.  ``register`` against JAX's on inputs that
  ``shard_batch(mesh, ..., shard_spatial=True)`` split over 2 devices of
  the 8-device CPU mesh (what ``__graft_entry__.py`` runs), and the step
  as above.

Bars (``tests/test_torch_spatial_joint.py``'s): ``register`` 1e-5
max-abs against JAX's sharded call; metrics 1e-4 relative; gradients
within 1e-3 of each network's max |g|; after ``train_step`` every rank's
parameters and Adam state bit-equal.  On the CPU the ranks' ``registered``
warp runs the plain version through ``gather_slabs``; B2's slab form is
held by ``tests/test_torch_spatial_joint_units.py`` (its plain model) and
``tests/test_torch_kernels_gpu.py`` (the card).  One launch of 4 ranks,
in a thread beside the JAX compiles."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.parallel import make_mesh, replicate, shard_batch
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.parallel.mesh import first_whole_level
from test_torch_spatial_joint import (NAMES, SHARDED_TOL, assembled, images,
                                      port_and_jax_params)
from test_torch_train import GRAD_ENV, KEY, LR, jax_patch_ids, tap_locations
from test_torch_zoo_train import close_metric, port_tree
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
B = 2
CFG32 = dict(crop_size=32, ngf=8, netG="resnet_2blocks", vxm_enc=(8, 16),
             vxm_dec=(16, 16, 8), netF_nc=16, num_patches=16)
# RegistrationConfig(crop_size=64, num_patches=64), the graft's, narrowed
GRAFT = dict(crop_size=64, ngf=8, netG="resnet_2blocks", vxm_enc=(8,) * 6,
             vxm_dec=(8,) * 7, netF_nc=16, num_patches=64)
# case: (config, n_spatial)
CASES = {"c32_1x2": (CFG32, 2), "c32_1x4": (CFG32, 4),
         "graft_1x2": (GRAFT, 2)}


def jax_step(cfg, jp, a, b):
    """JAX's train_step metrics, and its gradients (its Adam state's)."""
    jm = JaxModel(JaxConfig(**cfg))
    assert jm.cfg.beta1 == 0.5
    jp = jax.tree.map(jnp.copy, jp)          # the step donates its state
    new_state, metrics = jm.train_step(
        TrainState(params=jp, opt_state=jm.tx.init(jp),
                   step=jnp.zeros((), jnp.int32)),
        jnp.asarray(a), jnp.asarray(b), KEY, jnp.float32(LR))
    return jm, {k: float(v) for k, v in metrics.items()}, jax.tree.map(
        lambda m: 2.0 * np.asarray(m), dict(new_state.opt_state.mu))


@pytest.fixture(scope="module")
def setup():
    models, cases = {}, []
    for cfg_name, cfg, seed in (("c32", CFG32, 3), ("graft", GRAFT, 4)):
        init, state, jp = port_and_jax_params(cfg)
        a, b = images(seed, (B, cfg["crop_size"], cfg["crop_size"], 1))
        A, Bt = (torch.from_numpy(to_nchw(x)) for x in (a, b))
        ids = jax_patch_ids(KEY, tap_locations(init, A), cfg["num_patches"])
        models[cfg_name] = dict(init=init, jp=jp, a=a, b=b)
        for name, (case_cfg, n) in CASES.items():
            if case_cfg is cfg:
                cases.append((name, "joint_spatial_steps", {"job": dict(
                    cfg=cfg, state=state, loss=(A, Bt), loss_ids=ids,
                    eval=name == "c32_1x2", batches=[(A, Bt)], lr=LR,
                    patch_ids=[ids], n_data=1, n_spatial=n,
                    register=(A, Bt) if cfg is GRAFT else None)}))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, (cases,),
                         LIMIT)
    out = {"future": future, "models": models, "jax": {}}
    for cfg_name, cfg in (("c32", CFG32), ("graft", GRAFT)):
        m = models[cfg_name]
        jm, metrics, mu = jax_step(cfg, m["jp"], m["a"], m["b"])
        out["jax"][cfg_name] = dict(metrics=metrics,
                                    grads=port_tree(m["init"], mu))
    m = models["graft"]
    mesh = make_mesh(n_data=1, n_spatial=2, devices=jax.devices()[:2])
    As, Bs = shard_batch(mesh, (jnp.asarray(m["a"]), jnp.asarray(m["b"])),
                         shard_spatial=True)
    assert "spatial" in str(As.sharding.spec)
    out["register_sharded"] = [np.asarray(o) for o in jm.register(
        replicate(mesh, m["jp"]), As, Bs)]
    yield out
    pool.shutdown(wait=True)


def reports(setup, case):
    ranks = setup["future"].result(timeout=LIMIT + 60)
    return [r[case] for r in ranks if r[case].get("in_mesh", True)]


def jax_of(setup, case):
    return setup["jax"][case.split("_")[0]]


def test_the_graft_gathers_netRs_sixth_level():
    """Crop 64 over 2 ranks: netR's levels hold 32, 16, 8, 4, 2 and 1
    rows a rank, the sixth (1 row in all) does not split; crop 32 over 4
    splits at every level (None)."""
    assert first_whole_level(64, 2, len(GRAFT["vxm_enc"])) == 6
    assert first_whole_level(32, 4, len(CFG32["vxm_enc"])) is None


def test_graft_register_matches_jax_sharded(setup):
    reps = reports(setup, "graft_1x2")
    assert len(reps) == 2
    want = setup["register_sharded"]
    # the flows reach across the slabs' edge
    assert float(np.abs(want[3]).max()) > 0.5
    for i, name in enumerate(NAMES):
        np.testing.assert_allclose(to_nhwc(assembled(reps, i)), want[i],
                                   rtol=0, atol=SHARDED_TOL, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_2d_on_slabs_matches_jax(setup, case):
    want = jax_of(setup, case)["metrics"]
    reps = reports(setup, case)
    assert len(reps) == CASES[case][1]
    for r in reps:
        assert set(r["loss"]) == set(want)
        for k, ref in want.items():
            assert abs(r["loss"][k] - ref) <= 1e-4 * abs(ref), (
                k, r["loss"][k], ref)


@pytest.mark.parametrize("case", CASES)
def test_gradients_2d_on_slabs_match_jax(setup, case):
    rank0, = [r for r in reports(setup, case) if r["rank"] == 0]
    for net, ref in jax_of(setup, case)["grads"].items():
        got = rank0["loss_grads"][net]
        assert set(got) == set(ref), net
        scale = max(float(torch.as_tensor(g).abs().max())
                    for g in ref.values())
        assert scale > 0, net
        for name, g in ref.items():
            err = float((got[name] - torch.as_tensor(g)).abs().max())
            assert err <= GRAD_ENV * scale, (net, name, err, scale)


def test_eval_step_2d_on_slabs_matches_jax(setup):
    """eval_step on slabs: the global batch's metrics, the loss's."""
    want = jax_of(setup, "c32_1x2")["metrics"]
    for r in reports(setup, "c32_1x2"):
        for k, ref in want.items():
            assert abs(r["eval"][k] - ref) <= 1e-4 * abs(ref), (k, ref)


@pytest.mark.parametrize("case", CASES)
def test_train_step_2d_replicas_bit_equal(setup, case):
    """One train_step on slabs: its metrics the JAX step's, every rank's
    parameters and Adam state bit-equal after it, halos and gathers
    exchanged."""
    reps = reports(setup, case)
    want = jax_of(setup, case)["metrics"]
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
        assert r["bytes_sent"][0]["halo"] > 0 and r["bytes_sent"][0][
            "gather"] > 0, r["bytes_sent"]
        for k, ref in want.items():
            assert close_metric(r["metrics"][0][k], ref), (k, ref)
