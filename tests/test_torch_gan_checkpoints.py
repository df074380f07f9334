"""Checkpoints of the training options (engine/checkpoints.py,
compat/convert.py, models/registration.py): with ``--lambda_GAN > 0``
``net_D`` is saved and reloaded with its own Adam state, the JAX package's
``.msgpack`` with netD and its two-optimizer state ``(opt_gfr, opt_d)`` is
read by the port exactly, and a resumed GAN + dropout run is equal to an
uninterrupted one.  The JAX package cannot read the port's ``net_D.pth``
(its ``_pth_converter`` has no discriminator branch): recorded here.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dfmir_tpu.engine import checkpoints as jax_ckpt
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.models.registration import RegistrationTask as JaxTask
from dfmir_tpu_torch.compat import convert
from dfmir_tpu_torch.compat.convert import to_nchw
from dfmir_tpu_torch.models.registration import RegistrationTask
from test_torch_checkpoints import (KEY, LR, batch, few_threads,  # noqa: F401
                                    full_state, make_opt)

GAN = dict(lambda_GAN=1.0, ndf=8)


def d_state(task):
    sd = {f"D.{k}": v.clone() for k, v in task.engine.netD.state_dict()
          .items()}
    for i, st in task.engine.optimizer_D.state_dict()["state"].items():
        sd.update({f"adamD.{i}.{k}": v.clone() for k, v in st.items()})
    return sd


@pytest.fixture(scope="module")
def jax_gan_run(tmp_path_factory):
    """JAX: a GAN model's init_state, one two-phase train_step, `latest`
    saved with net_D and (opt_gfr, opt_d)."""
    tmp = tmp_path_factory.mktemp("gan")
    opt = make_opt(tmp, **GAN)
    jm = JaxModel(JaxConfig.from_opt(opt))
    state = jm.init_state(jax.random.PRNGKey(0), batch_size=1)
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((1, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    state, _ = jm.train_step(state, jnp.asarray(a), jnp.asarray(b), KEY,
                             jnp.float32(LR))
    jax_ckpt.save_networks(str(tmp / "ck" / "exp"), "latest", state.params,
                           opt_extras={"opt_state": state.opt_state,
                                       "step": state.step})
    host = jax.tree.map(np.asarray, {
        "params": state.params,
        "opt_state": serialization.to_state_dict(state.opt_state)})
    return dict(opt=opt, host=host, tmp=tmp)


def test_port_reads_a_jax_gan_checkpoint(jax_gan_run):
    s = jax_gan_run
    assert (s["tmp"] / "ck" / "exp" / "latest_net_D.msgpack").exists()
    task = RegistrationTask(s["opt"])
    assert task.model_names == ["G", "F", "R", "D"]
    task.load_networks("latest")
    eng, params = task.engine, s["host"]["params"]
    for name in ("G", "F", "R", "D"):
        want = convert.net_state_from_jax(eng, name, params[name])
        sd = getattr(eng, convert.ALL_NETS[name]).state_dict()
        assert want and all(torch.equal(sd[k], v) for k, v in want.items())
    gfr, d = (s["host"]["opt_state"][i] for i in ("0", "1"))
    for optimizer, net, tree in (
            (eng.optimizer_D, eng.netD, d),
            (eng.optimizer, eng.netG, gfr)):
        mu = (convert.netD_state_from_jax(tree["mu"], net) if net is eng.netD
              else convert.net_state_from_jax(eng, "G", tree["mu"]["G"]))
        state = optimizer.state_dict()["state"]
        for i, (k, _) in enumerate(net.named_parameters()):
            assert float(state[i]["step"]) == float(tree["count"]) == 1.0
            assert torch.equal(state[i]["exp_avg"], mu[k]), k
    assert task.step == 1


def test_gan_and_dropout_resume_is_exact(tmp_path):
    kw = dict(GAN, no_dropout=False)
    run = RegistrationTask(make_opt(tmp_path, name="run", **kw))
    for seed in (1, 2):
        run.set_input(batch(seed))
        run.optimize_parameters()
    run.save_networks("latest")
    names = sorted(p.name for p in (tmp_path / "ck" / "run").glob("*.pth"))
    assert names == ["latest_net_D.pth", "latest_net_F.pth",
                     "latest_net_G.pth", "latest_net_R.pth",
                     "latest_optim.pth"]
    optim = torch.load(tmp_path / "ck" / "run" / "latest_optim.pth",
                       weights_only=True)
    assert {"optimizer_D", "dropout_generator"} <= set(optim)

    resumed = RegistrationTask(make_opt(tmp_path, name="run",
                                        continue_train=True, seed=9, **kw))
    resumed.setup(resumed.opt)
    for got, want in ((full_state(resumed), full_state(run)),
                      (d_state(resumed), d_state(run))):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), [
            k for k in want if not torch.equal(got[k], want[k])][:4]
    assert torch.equal(resumed.engine.dropout_generator.get_state(),
                       run.engine.dropout_generator.get_state())
    for task in (run, resumed):
        task.set_input(batch(3))
        task.optimize_parameters()
    assert resumed.get_current_losses() == run.get_current_losses()
    assert {"G_GAN", "D"} <= set(run.get_current_losses())
    for got, want in ((full_state(resumed), full_state(run)),
                      (d_state(resumed), d_state(run))):
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_test_task_skips_D(tmp_path):
    run = RegistrationTask(make_opt(tmp_path, name="run", **GAN))
    run.set_input(batch(1))
    run.optimize_parameters()
    run.save_networks("latest")
    tested = RegistrationTask(make_opt(tmp_path, name="run", train=False,
                                       **GAN))
    tested.setup(tested.opt)
    assert tested.model_names == ["G", "R"]
    A = torch.from_numpy(to_nchw(np.zeros((1, 64, 64, 1), np.float32)))
    for x, y in zip(tested.register_pair(A, A), run.register_pair(A, A)):
        assert torch.equal(x, y)


def test_jax_cannot_read_a_port_net_D():
    """The JAX package's reference-.pth path converts G, F and R only."""
    with pytest.raises(KeyError):
        JaxTask._pth_converter(types.SimpleNamespace(cfg=None), "D", {})
