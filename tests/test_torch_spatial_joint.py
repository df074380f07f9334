"""The joint model (``RegistrationModel``) with its images split along
axis 2 (JAX's ``spatial`` mesh axis: H at 2-D, D at 3-D) over ``gloo``
ranks on the CPU, against the JAX RegistrationModel, from the same
weights (the port's initial ones through JAX's converters, the flow head
scaled by ``FLOW_GAIN`` so that the warps move pixels across the slabs'
edges) and the patch ids the JAX step draws:

- 2-D ``register`` (crop 32, ngf 8, vxm_enc (8, 16)) on 1 x 2 and 1 x 4
  meshes at B=2: each rank's slabs put together against JAX's
  ``register`` on the whole batch, and against the same call on inputs
  that ``shard_batch(mesh, ..., shard_spatial=True)`` split over 2
  devices of the 8-device CPU mesh (what ``__graft_entry__.py`` runs);
- 3-D ``register``, ``loss_fn`` (metrics and gradients, averaged over
  the ranks), ``eval_step`` and one ``train_step`` at 16^3 on 1 x 2 and 2
  x 2 meshes at global B=2, against JAX's ``register`` and the metrics
  and gradients of its ``train_step`` (its ``_loss_fn``'s; g = 2 mu, as
  ``tests/test_torch_joint3d.py`` reads them).

Bars: ``register`` 1e-5 max-abs against JAX's sharded call (JAX's own bar
for a sharded register, ``tests/test_vxm3d.py``) and the whole-image
parity bars against the unsharded calls (1e-3, ``PARITY.json``); metrics
1e-4 relative; gradients within 1e-3 of each network's max |g|; after
``train_step`` every rank's parameters and Adam state bit-equal.  One
launch of 4 ranks, in a thread beside the JAX compiles."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.parallel import make_mesh, replicate, shard_batch
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_joint3d import jax_patch_ids3d, tap_locations3d
from test_torch_train import GRAD_ENV, KEY, LR
from test_torch_zoo_train import close_metric, port_tree
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
FLOW_GAIN = 1e5      # the flow head N(0, 1e-5) -> about a pixel / voxel
REGISTER_TOL = 1e-3  # the whole-image parity bar
SHARDED_TOL = 1e-5   # JAX's bar for a sharded register
CFG2D = dict(crop_size=32, ngf=8, netG="resnet_2blocks", vxm_enc=(8, 16),
             vxm_dec=(16, 16, 8), netF_nc=16, num_patches=16)
# netR 3 levels deep: a 16^3 volume over 2 spatial ranks (check_joint_slabs)
CFG3D = dict(ndims=3, crop_size=16, ngf=8, netG="resnet_2blocks",
             vxm_enc=(4, 4, 4), vxm_dec=(4, 4, 4, 4, 4), netF_nc=16,
             num_patches=16, int_steps=2)
MESHES2D = {"1x2": (1, 2), "1x4": (1, 4)}
MESHES3D = {"1x2": (1, 2), "2x2": (2, 2)}
NAMES = ("fake_B", "idt_B", "y_source", "pos_flow")


def port_and_jax_params(cfg):
    """The port's initial weights (flow head times FLOW_GAIN) as state
    dicts, and the same weights as JAX's tree (JAX's own converters)."""
    init = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        init.netR.flow.weight.mul_(FLOW_GAIN)
    params = {"G": jax_convert.convert_netG(init.netG.state_dict(),
                                            init.netG.specs),
              "F": jax_convert.convert_netF(init.netF.state_dict(),
                                            len(init.cfg.nce_layers)),
              "R": jax_convert.convert_netR(init.netR.state_dict(),
                                            cfg["vxm_enc"], cfg["vxm_dec"])}
    # copies: a launch moves the tensors it sends into shared memory, and
    # the converters' arrays may share the parameters' memory
    state = {k: {n: v.clone() for n, v in net.state_dict().items()}
             for k, net in (("G", init.netG), ("F", init.netF),
                            ("R", init.netR))}
    return init, state, jax.tree.map(
        lambda x: jnp.asarray(np.array(x, copy=True)), params)


def images(seed, shape):
    rng = np.random.default_rng(seed)
    return [np.tanh(2 * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def setup():
    init2, state2, jp2 = port_and_jax_params(CFG2D)
    init3, state3, jp3 = port_and_jax_params(CFG3D)
    a2, b2 = images(0, (2, 32, 32, 1))
    a3, b3 = images(1, (2, 16, 16, 16, 1))
    A2, B2 = (torch.from_numpy(to_nchw(x)) for x in (a2, b2))
    A3, B3 = (torch.from_numpy(to_nchw(x)) for x in (a3, b3))
    ids = jax_patch_ids3d(KEY, tap_locations3d(init3, A3),
                          CFG3D["num_patches"])
    cases = [(f"2d_{name}", "joint_spatial_steps", {"job": dict(
        cfg=CFG2D, state=state2, register=(A2, B2), n_data=n, n_spatial=s)})
        for name, (n, s) in MESHES2D.items()]
    cases += [(f"3d_{name}", "joint_spatial_steps", {"job": dict(
        cfg=CFG3D, state=state3, register=(A3, B3), loss=(A3, B3),
        loss_ids=ids, eval=name == "1x2", batches=[(A3, B3)], lr=LR,
        patch_ids=[ids], n_data=n, n_spatial=s)})
        for name, (n, s) in MESHES3D.items()]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, (cases,),
                         LIMIT)

    jm2, jm3 = JaxModel(JaxConfig(**CFG2D)), JaxModel(JaxConfig(**CFG3D))
    out = {"future": future, "init3": init3}
    out["register2d"] = [np.asarray(o) for o in jm2.register(
        jp2, jnp.asarray(a2), jnp.asarray(b2))]
    mesh = make_mesh(n_data=1, n_spatial=2, devices=jax.devices()[:2])
    As, Bs = shard_batch(mesh, (jnp.asarray(a2), jnp.asarray(b2)),
                         shard_spatial=True)
    assert "spatial" in str(As.sharding.spec)
    out["register2d_sharded"] = [np.asarray(o) for o in jm2.register(
        replicate(mesh, jp2), As, Bs)]
    out["register3d"] = [np.asarray(o) for o in jm3.register(
        jp3, jnp.asarray(a3), jnp.asarray(b3))]
    assert jm3.cfg.beta1 == 0.5
    new_state, metrics = jm3.train_step(
        TrainState(params=jp3, opt_state=jm3.tx.init(jp3),
                   step=jnp.zeros((), jnp.int32)),
        jnp.asarray(a3), jnp.asarray(b3), KEY, jnp.float32(LR))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["grads"] = port_tree(init3, jax.tree.map(
        lambda m: 2.0 * np.asarray(m), dict(new_state.opt_state.mu)))
    yield out
    pool.shutdown(wait=True)


def reports(setup, case):
    """The reports of the case's mesh's ranks (the launch's first)."""
    ranks = setup["future"].result(timeout=LIMIT + 60)
    return [r[case] for r in ranks if r[case].get("in_mesh", True)]


def assembled(reps, i):
    """The ranks' slabs of ``register``'s output i, put back together:
    along axis 2 in spatial order, the data ranks along the batch."""
    n_data = 1 + max(r["data_rank"] for r in reps)
    return torch.cat([
        torch.cat([r["register"][i] for r in sorted(
            reps, key=lambda q: q["spatial_rank"]) if r["data_rank"] == d],
            dim=2) for d in range(n_data)])


@pytest.mark.parametrize("mesh", MESHES2D)
def test_register_2d_matches_jax(setup, mesh):
    reps = reports(setup, f"2d_{mesh}")
    assert len(reps) == MESHES2D[mesh][1]
    # the flows reach across the slabs' edges
    assert float(np.abs(setup["register2d"][3]).max()) > 0.5
    for i, name in enumerate(NAMES):
        got = to_nhwc(assembled(reps, i))
        np.testing.assert_allclose(got, setup["register2d_sharded"][i],
                                   rtol=0, atol=SHARDED_TOL, err_msg=name)
        np.testing.assert_allclose(got, setup["register2d"][i], rtol=0,
                                   atol=REGISTER_TOL, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES3D)
def test_register_3d_matches_jax(setup, mesh):
    reps = reports(setup, f"3d_{mesh}")
    assert len(reps) == 4 if mesh == "2x2" else 2
    assert float(np.abs(setup["register3d"][3]).max()) > 0.5
    for i, name in enumerate(NAMES):
        np.testing.assert_allclose(to_nhwc(assembled(reps, i)),
                                   setup["register3d"][i], rtol=0,
                                   atol=REGISTER_TOL, err_msg=name)


@pytest.mark.parametrize("mesh", MESHES3D)
def test_loss_fn_3d_matches_jax(setup, mesh):
    want = setup["metrics"]
    for r in reports(setup, f"3d_{mesh}"):
        assert set(r["loss"]) == set(want)
        for k, ref in want.items():
            assert abs(r["loss"][k] - ref) <= 1e-4 * abs(ref), (
                k, r["loss"][k], ref)


@pytest.mark.parametrize("mesh", MESHES3D)
def test_gradients_3d_match_jax(setup, mesh):
    rank0 = [r for r in reports(setup, f"3d_{mesh}") if r["rank"] == 0][0]
    for net, ref in setup["grads"].items():
        got = rank0["loss_grads"][net]
        assert set(got) == set(ref), net
        scale = max(float(torch.as_tensor(g).abs().max())
                    for g in ref.values())
        assert scale > 0, net
        for name, g in ref.items():
            err = float((got[name] - torch.as_tensor(g)).abs().max())
            assert err <= GRAD_ENV * scale, (net, name, err, scale)


def test_eval_step_3d_on_slabs_matches_jax(setup):
    """eval_step on slabs: the global batch's metrics, the loss's."""
    for r in reports(setup, "3d_1x2"):
        for k, ref in setup["metrics"].items():
            assert abs(r["eval"][k] - ref) <= 1e-4 * abs(ref), (k, ref)


@pytest.mark.parametrize("mesh", MESHES3D)
def test_train_step_3d_replicas_bit_equal(setup, mesh):
    """One train_step on slabs: its metrics the JAX step's, every rank's
    parameters and Adam state bit-equal after it, and the step launching
    the 3-D step's kernels (none counted on the CPU ranks)."""
    reps = reports(setup, f"3d_{mesh}")
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
        for k, ref in setup["metrics"].items():
            assert close_metric(r["metrics"][0][k], ref), (k, ref)
