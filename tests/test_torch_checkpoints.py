"""Checkpoints both ways between the port and the JAX package, and exact
resume (dfmir_tpu_torch/engine/checkpoints.py, compat/convert.py,
models/registration.py):

(a) JAX takes one train_step and saves ``latest`` (.msgpack); the port's
    task loads it: weights equal to load_jax_params of the same tree, Adam
    moments and count equal to the mapped mu / nu / count exactly,
    register within 1e-5, and one more step on each side with the same
    patch ids within test_torch_train.py's bars;
(b) the port saves .pth; the JAX task loads it through its reference-.pth
    path and registers within 1e-3 of the port;
(c) save, load into a fresh task and one optimize_parameters are
    torch.equal to an uninterrupted step;
(d) save_with_config round trips for RegistrationConfig and VxmConfig.
"""

import argparse
import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine import checkpoints as jax_ckpt
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.models.registration import RegistrationTask as JaxTask
from dfmir_tpu.nets import resnet_generator_specs
from dfmir_tpu_torch.compat import convert
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine import checkpoints as ckpt
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.models.registration import RegistrationTask
from dfmir_tpu_torch.options import TrainOptions

# the CPU tests' config (test_torch_train.py), with the fields the command
# line does not carry set on the options
SMALL = dict(vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8),
             netF_nc=16, num_patches=16)
FLOW_GAIN = 1e5
LR = 2e-4
GRAD_ENV = 1e-3
KEY = jax.random.PRNGKey(11)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's small steps: the suite runs
    several files at once, and a pool the size of the machine in each
    of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def make_opt(tmp, name="exp", train=True, **kw):
    argv = ["--dataroot", str(tmp), "--name", name, "--checkpoints_dir",
            str(tmp / "ck"), "--gpu_ids", "-1", "--crop_size", "64",
            "--ngf", "8", "--netG", "resnet_4blocks", "--seed", "4"]
    with contextlib.redirect_stdout(io.StringIO()):
        opt = TrainOptions(argv).parse()
    for k, v in dict(SMALL, **kw).items():
        setattr(opt, k, v)
    opt.isTrain = train
    return opt


def jax_patch_ids(key, n_locs, num_patches):
    """The ids the JAX step draws for its NCE calls (as in
    test_torch_train.py)."""
    kF = jax.random.split(key, 5)[:3]
    return [[torch.from_numpy(np.asarray(jax.random.permutation(
                 jax.random.fold_in(k, layer), n)[:min(num_patches, n)]
             ).astype(np.int64)) for layer, n in enumerate(n_locs)]
            for k in kF]


def tap_locations(model, x):
    with torch.no_grad():
        feats = model.netG(x, layers=tuple(model.cfg.nce_layers),
                           encode_only=True)
    return [f.shape[2] * f.shape[3] for f in feats]


def jax_tree(model):
    """A port RegistrationModel's weights as a JAX param tree, through the
    JAX package's own converter (its reference-.pth path), which gives
    init_state's tree structure without the JAX package's eager init."""
    cfg = model.cfg
    specs = resnet_generator_specs(ngf=cfg.ngf, n_blocks=cfg.n_blocks)
    return {"G": jax_convert.convert_netG(model.netG.state_dict(), specs),
            "F": jax_convert.convert_netF(model.netF.state_dict(),
                                          len(cfg.nce_layers)),
            "R": jax_convert.convert_netR(model.netR.state_dict(),
                                          cfg.vxm_enc, cfg.vxm_dec)}


def named(model, tree):
    return {name: convert.net_state_from_jax(model, name, tree[name])
            for name in convert.NETS}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX: random weights (drawn by the port, in the JAX tree), the flow
    head scaled, one train_step, save ``latest``; then the state after a
    second step with KEY2's ids."""
    tmp = tmp_path_factory.mktemp("ckpt")
    opt = make_opt(tmp)
    jm = JaxModel(JaxConfig.from_opt(opt))
    params = jax_tree(RegistrationModel(
        RegistrationConfig.from_opt(opt), device="cpu",
        generator=torch.Generator().manual_seed(0)))
    params["R"]["flow"]["kernel"] *= FLOW_GAIN
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(params=jp, opt_state=jm.tx.init(jp),
                       step=jnp.zeros((), jnp.int32))
    # batches of 2 in test_torch_train.py's config: the same programs as
    # that file's and test_torch_register.py's, which the tests' persistent
    # compilation cache then shares
    rng = np.random.default_rng(0)
    a, b, a2, b2 = (np.tanh(2 * rng.standard_normal((2, 64, 64, 1))).astype(
        np.float32) for _ in range(4))
    state, _ = jm.train_step(state, jnp.asarray(a), jnp.asarray(b), KEY,
                             jnp.float32(LR))
    save_dir = tmp / "ck" / "exp"
    jax_ckpt.save_networks(str(save_dir), "latest", state.params,
                           opt_extras={"opt_state": state.opt_state,
                                       "step": state.step})
    host = jax.tree.map(np.asarray, {"params": state.params,
                                     "opt_state": serialization.to_state_dict(
                                         state.opt_state)})
    ref_register = jax.tree.map(np.asarray, jm.register(
        state.params, jnp.asarray(a2), jnp.asarray(b2)))
    key2 = jax.random.PRNGKey(12)
    state2, metrics2 = jm.train_step(state, jnp.asarray(a2), jnp.asarray(b2),
                                     key2, jnp.float32(LR))
    return dict(tmp=tmp, opt=opt, host=host, a2=a2, b2=b2, key2=key2,
                register=ref_register, params2=jax.tree.map(
                    np.asarray, state2.params),
                metrics2={k: float(v) for k, v in metrics2.items()})


def test_read_flax_msgpack_matches_flax(jax_run):
    save_dir = jax_run["tmp"] / "ck" / "exp"
    for stem in ("net_G", "net_F", "net_R", "optim"):
        path = save_dir / f"latest_{stem}.msgpack"
        mine = convert.read_flax_msgpack(str(path))
        ref = serialization.msgpack_restore(path.read_bytes())
        assert jax.tree.structure(mine) == jax.tree.structure(ref)
        for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    chunked = {"w": {"__msgpack_chunked_array__": True,
                     "shape": {"0": 2, "1": 3},
                     "chunks": {"0": np.arange(4.0), "1": np.arange(4, 6.0)}}}
    np.testing.assert_array_equal(convert._unchunk(chunked)["w"],
                                  np.arange(6.0).reshape(2, 3))


def test_port_loads_a_jax_checkpoint(jax_run):
    s = jax_run
    task = RegistrationTask(s["opt"])
    task.load_networks("latest")
    params = s["host"]["params"]
    want = named(task.engine, params)
    for name, attr in convert.NETS.items():
        sd = getattr(task.engine, attr).state_dict()
        for k, v in want[name].items():
            assert torch.equal(sd[k], v), (name, k)
    opt_state = s["host"]["opt_state"]
    mu, nu = (named(task.engine, opt_state[m]) for m in ("mu", "nu"))
    state = task.engine.optimizer.state_dict()["state"]
    index = 0
    for name, attr in convert.NETS.items():
        for k, _ in getattr(task.engine, attr).named_parameters():
            st = state[index]
            assert float(st["step"]) == float(opt_state["count"]) == 1.0
            assert torch.equal(st["exp_avg"], mu[name][k]), (name, k)
            assert torch.equal(st["exp_avg_sq"], nu[name][k]), (name, k)
            index += 1
    assert index == len(state) and task.step == 1

    A, B = (torch.from_numpy(to_nchw(x)) for x in (s["a2"], s["b2"]))
    out = task.register_pair(A, B)
    assert np.abs(s["register"][3]).max() > 0.5          # the field deforms
    for name, o, r in zip(("fake_B", "idt_B", "y_source", "pos_flow"), out,
                          s["register"]):
        np.testing.assert_allclose(to_nhwc(o), r, rtol=0, atol=1e-5,
                                   err_msg=name)

    # one more step on each side, the same patch ids
    ids = jax_patch_ids(s["key2"], tap_locations(task.engine, A),
                        task.cfg.num_patches)
    metrics = task.engine.train_step(A, B, LR, patch_ids=ids)
    for k, r in s["metrics2"].items():
        assert abs(float(metrics[k]) - r) <= 1e-4 * abs(r), k
    # the noise band from the port's own gradients of the step, which
    # test_torch_train.py holds to GRAD_ENV of JAX's
    ref = named(task.engine, s["params2"])
    total = mismatched = 0
    for name, attr in convert.NETS.items():
        grads = dict(getattr(task.engine, attr).named_parameters())
        noise = GRAD_ENV * max(float(g.grad.abs().max())
                               for g in grads.values())
        for k, p in grads.items():
            g, p, r = p.grad, p.detach(), ref[name][k]
            mism = ~torch.isclose(p, r, atol=1e-5, rtol=1e-4)
            total += p.numel()
            mismatched += int(mism.sum())
            if mism.any():      # a first-step Adam sign artefact at most
                assert float((p - r)[mism].abs().max()) <= 2.05 * LR, k
                assert float(g[mism].abs().max()) <= noise, k
    assert mismatched < 0.01 * total, (mismatched, total)


def test_jax_loads_a_port_checkpoint(jax_run, tmp_path):
    opt = make_opt(tmp_path, name="port")
    task = RegistrationTask(opt)
    with torch.no_grad():
        task.engine.netR.flow.weight.mul_(FLOW_GAIN)
    rng = np.random.default_rng(1)
    a, b = (np.tanh(2 * rng.standard_normal((2, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    A, B = (torch.from_numpy(to_nchw(x)) for x in (a, b))
    task.set_input({"A": to_nchw(a), "B": to_nchw(b), "A_paths": ["x", "y"]})
    task.optimize_parameters()
    task.save_networks("latest")
    names = sorted(p.name for p in (tmp_path / "ck" / "port").iterdir())
    assert names == ["latest_net_F.pth", "latest_net_G.pth",
                     "latest_net_R.pth", "latest_optim.pth", "train_opt.txt"]
    for p in (tmp_path / "ck" / "port").glob("*.pth"):
        torch.load(p, weights_only=True)           # plain containers only

    jopt = argparse.Namespace(**vars(make_opt(tmp_path, name="port",
                                              train=False)))
    jtask = JaxTask(jopt)
    # a state of other weights in place of the task's eager init (setup
    # keeps a state it has); setup then loads G and R from the .pth
    other = jax.tree.map(jnp.asarray, jax_run["host"]["params"])
    jtask.state = TrainState(params=other, opt_state=jtask.engine.tx.init(
        other), step=jnp.zeros((), jnp.int32))
    jtask.setup(jopt)                   # isTrain False: G and R, from .pth
    assert not np.array_equal(np.asarray(jtask.state.params["R"]["flow"][
        "kernel"]), np.asarray(other["R"]["flow"]["kernel"]))
    ref = jtask.register_pair(jnp.asarray(a), jnp.asarray(b))
    out = task.register_pair(A, B)
    assert np.abs(np.asarray(ref[3])).max() > 0.5
    for name, o, r in zip(("fake_B", "idt_B", "y_source", "pos_flow"), out,
                          ref):
        np.testing.assert_allclose(to_nhwc(o), np.asarray(r), rtol=0,
                                   atol=1e-3, err_msg=name)

    test_task = RegistrationTask(make_opt(tmp_path, name="port",
                                          train=False))
    test_task.setup(test_task.opt)               # G and R, no optimizer
    assert test_task.model_names == ["G", "R"] and test_task.step == 0
    assert torch.equal(test_task.engine.netR.flow.weight,
                       task.engine.netR.flow.weight)
    assert test_task.engine.optimizer.state_dict()["state"] == {}


def batch(seed):
    rng = np.random.default_rng(seed)
    return {"A": rng.integers(0, 256, (1, 1, 64, 64), dtype=np.uint8),
            "B": rng.integers(0, 256, (1, 1, 64, 64), dtype=np.uint8),
            "A_paths": ["a.png"]}


def full_state(task):
    sd = {f"{n}.{k}": v.clone() for n, net in task._nets().items()
          for k, v in net.state_dict().items()}
    for i, st in task.engine.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            sd[f"adam.{i}.{k}"] = v.clone()
    return sd


def test_resume_is_exact(tmp_path):
    torch.manual_seed(0)
    uninterrupted = RegistrationTask(make_opt(tmp_path, name="run"))
    for seed in (1, 2):
        uninterrupted.set_input(batch(seed))
        uninterrupted.optimize_parameters()
    uninterrupted.save_networks("latest")
    uninterrupted.set_input(batch(3))
    uninterrupted.optimize_parameters()

    resumed = RegistrationTask(make_opt(tmp_path, name="run",
                                        continue_train=True, seed=9))
    resumed.setup(resumed.opt)
    assert resumed.step == 2
    resumed.set_input(batch(3))
    resumed.optimize_parameters()
    assert resumed.step == 3
    mine, ref = full_state(resumed), full_state(uninterrupted)
    assert mine.keys() == ref.keys() and len(mine) > 100
    for k in ref:
        assert torch.equal(mine[k], ref[k]), k
    assert resumed.get_current_losses() == uninterrupted.get_current_losses()


def test_pretrained_name_warm_start(tmp_path):
    first = RegistrationTask(make_opt(tmp_path, name="first"))
    first.save_networks("latest")
    other = RegistrationTask(make_opt(tmp_path, name="second", seed=5,
                                      continue_train=True,
                                      pretrained_name="first"))
    other.setup(other.opt)
    assert torch.equal(other.engine.netG.model[1].weight,
                       first.engine.netG.model[1].weight)
    with pytest.raises(FileNotFoundError, match="net G"):
        RegistrationTask(make_opt(tmp_path, name="third",
                                  continue_train=True)).setup(
            make_opt(tmp_path, name="third", continue_train=True))


@pytest.mark.parametrize("kind", ["registration", "vxm"])
def test_save_with_config_round_trip(tmp_path, kind):
    if kind == "registration":
        cfg = RegistrationConfig(crop_size=64, ngf=8, netG="resnet_4blocks",
                                 **SMALL)
        task = RegistrationTask(make_opt(tmp_path))
        nets = {n: net.state_dict() for n, net in task._nets().items()}
    else:
        cfg = VxmConfig(vol_size=32, enc=(8, 16, 16, 16),
                        dec=(16, 16, 16, 16, 16, 8, 8), image_loss="mse")
        nets = {"R": VxmEngine(cfg, device="cpu").netR.state_dict()}
    path = tmp_path / "blob.pth"
    ckpt.save_with_config(str(path), cfg, nets)
    cfg2, params = ckpt.load_with_config(str(path))
    assert type(cfg2) is type(cfg) and cfg2 == cfg
    assert params.keys() == nets.keys()
    for n in nets:
        assert params[n].keys() == nets[n].keys()
        for k in nets[n]:
            assert torch.equal(params[n][k], nets[n][k])
