"""The port's ``--model vxm`` task (dfmir_tpu_torch/models/vxm.py::VxmTask)
against the JAX package's VxmTask, both built from one command line
(TrainOptions, --gpu_ids -1) at the JAX 3-D suite's small config (24^3,
enc (8,16), dec (16,16,8), 4 integration steps, lr 1e-3) and from the same
weights (the port's, flow head scaled so that the field deforms, carried
into the JAX task by the JAX package's own converter).

Three steps through set_input / optimize_parameters at NCC, here; at mse
and with --bidir in test_torch_vxm_task_losses.py (a file of its own, so
that the suite's workers compile the JAX steps side by side): losses
within 1e-4 relative, parameters within atol 1e-5 / rtol 1e-4 but for
Adam's sign artefacts (the rule of
test_torch_vxm3d.py::test_train_step_matches_jax), registration_stats and
the visuals within 1e-5.  Checkpoints: the JAX task's
``latest_net_R.msgpack`` / ``latest_optim.msgpack`` load into the port's
task with weights, both Adam moments and the step equal to the converted
JAX state, and the port's own resume is exact."""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine.vxm_engine import VxmState
from dfmir_tpu.models.vxm import VxmTask as JaxVxmTask
from dfmir_tpu.options import TrainOptions as JaxTrainOptions
from dfmir_tpu_torch.compat import convert
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.models.vxm import VxmTask
from dfmir_tpu_torch.options import TrainOptions

S = 24
ENC, DEC = (8, 16), (16, 16, 8)
SMALL = ["--model", "vxm", "--vol_size", str(S), "--enc", "8,16", "--dec",
         "16,16,8", "--int_steps", "4", "--lr", "1e-3", "--gpu_ids", "-1"]
FLOW_GAIN = 1e5     # flow head N(0, 1e-5) -> N(0, 1): the warps deform
LR = 1e-3
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's small steps (several test
    files run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def parse(cls, argv):
    if cls is JaxTrainOptions:
        argv = " ".join(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return cls(argv).parse()


def make_argv(tmp, name, extra=()):
    return ["--dataroot", str(tmp / "data"), "--name", name,
            "--checkpoints_dir", str(tmp / "ck"), *SMALL, *extra]


def volumes(seed, n):
    """Textured (1, S, S, S, 1) volumes in [0, 1], NDHWC."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(0, 2 * np.pi, S)] * 3,
                             indexing="ij"))
    out = []
    for _ in range(n):
        a, b, c = rng.uniform(0.5, 2.0, 3)
        ph = rng.uniform(0, np.pi, 3)
        v = (np.sin(a * g[0] + ph[0]) * np.cos(b * g[1] + ph[1])
             * np.sin(c * g[2] + ph[2]) + 0.1 * rng.standard_normal((S,) * 3))
        out.append(((v - v.min()) / (v.max() - v.min())).astype(
            np.float32)[None, ..., None])
    return out


def batches(seed):
    vols = volumes(seed, 2 * STEPS)
    return [{"A": vols[2 * i], "B": vols[2 * i + 1],
             "A_paths": [f"a{i}.npy"]} for i in range(STEPS)]


def port_batch(b):
    return {"A": to_nchw(b["A"]), "B": to_nchw(b["B"]),
            "A_paths": b["A_paths"]}


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def paired_tasks(tmp, name, extra=()):
    """The port's task (its weights from --seed, the flow head scaled) and
    the JAX task carrying the same weights and a fresh Adam state."""
    argv = make_argv(tmp, name, extra)
    mine = VxmTask(parse(TrainOptions, argv))
    with torch.no_grad():
        mine.engine.netR.flow.weight.mul_(FLOW_GAIN)
    ref = JaxVxmTask(parse(JaxTrainOptions, argv))
    params = jax.tree.map(jnp.asarray, jax_convert.convert_netR(
        mine.engine.netR.state_dict(), ENC, DEC))
    ref.state = VxmState(params=params, opt_state=ref.engine.tx.init(params),
                         step=jnp.zeros((), jnp.int32))
    return mine, ref


def run_jax(ref, steps):
    """The JAX task over ``steps``: its losses a step, then its params,
    Adam state, step, stats and visuals (numpy)."""
    losses = []
    for b in steps:
        ref.set_input(b)
        ref.optimize_parameters()
        losses.append(dict(ref.get_current_losses()))
    state = ref.state
    return dict(losses=losses, params=numpy_tree(state.params),
                mu=numpy_tree(state.opt_state.mu),
                nu=numpy_tree(state.opt_state.nu),
                count=int(state.opt_state.count), step=int(state.step))


@pytest.fixture(scope="module")
def ncc_run(tmp_path_factory):
    """Three steps of the JAX task at NCC, its stats and visuals on the
    last batch, and its checkpoint ``latest`` (.msgpack)."""
    tmp = tmp_path_factory.mktemp("vxm_task")
    mine, ref = paired_tasks(tmp, "ncc")
    steps = batches(0)
    out = run_jax(ref, steps)
    out["stats"] = dict(ref.registration_stats())
    out["visuals"] = {k: np.asarray(v)
                      for k, v in ref.get_current_visuals().items()}
    ref.save_networks("latest")
    return dict(out, tmp=tmp, mine=mine, steps=steps,
                jax_dir=ref.save_dir)


def assert_params_match(engine, params, steps):
    """Within atol 1e-5 / rtol 1e-4, but for Adam's sign artefacts (a
    near-zero gradient whose sign the two programs' roundings set apart):
    fewer than 1% of the elements, each off by at most 2.05 * lr a step,
    the rule of test_torch_vxm3d.py::test_train_step_matches_jax."""
    ref = convert.netR_state_from_jax(params, ENC, DEC)
    assert set(ref) == {k for k, _ in engine.netR.named_parameters()}
    total = mismatched = 0
    for k, p in engine.netR.named_parameters():
        p, q = p.detach(), ref[k]
        mism = ~torch.isclose(p, q, atol=1e-5, rtol=1e-4)
        total += p.numel()
        mismatched += int(mism.sum())
        if mism.any():
            assert float((p - q)[mism].abs().max()) <= 2.05 * LR * steps, k
    assert mismatched < 0.01 * total, (mismatched, total)


def check_steps(mine, run, steps):
    """The port's task over ``steps`` against the JAX run."""
    for b, want in zip(steps, run["losses"]):
        mine.set_input(port_batch(b))
        mine.optimize_parameters()
        got = mine.get_current_losses()
        assert list(got) == list(want) == ["sim", "smooth", "total"]
        for k, r in want.items():
            assert abs(got[k] - r) <= 1e-4 * abs(r), (k, got[k], r)
    assert mine.step == run["step"] == len(steps)
    assert_params_match(mine.engine, run["params"], len(steps))


def test_steps_match_jax_at_ncc(ncc_run):
    check_steps(ncc_run["mine"], ncc_run, ncc_run["steps"])
    assert ncc_run["losses"][0]["smooth"] > 0        # the field deforms


def test_stats_and_visuals_match_jax(ncc_run):
    """After the steps (run after test_steps_match_jax_at_ncc, on the
    same task; alone, on its own steps)."""
    mine = ncc_run["mine"]
    if mine.step == 0:
        check_steps(mine, ncc_run, ncc_run["steps"])
    stats = mine.registration_stats()
    assert set(stats) == set(ncc_run["stats"])
    assert ncc_run["stats"]["flow_max"] > 0.5
    for k, r in ncc_run["stats"].items():
        assert abs(stats[k] - r) <= 1e-5 * max(1.0, abs(r)), (k, stats[k], r)
    vis = mine.get_current_visuals()
    assert list(vis) == ["source", "target", "registered"]
    for k, r in ncc_run["visuals"].items():
        assert r.shape == (1, S, S, 1) and vis[k].shape == (1, 1, S, S)
        np.testing.assert_allclose(to_nhwc(vis[k]), r, rtol=0, atol=1e-5,
                                   err_msg=k)
    assert float(vis["source"].min()) >= -1.0 and float(
        vis["source"].max()) <= 1.0


def test_port_loads_the_jax_checkpoint(ncc_run):
    """JAX's latest_net_R.msgpack and latest_optim.msgpack (no .pth
    beside them) into a fresh task: weights, Adam's moments and the step
    equal to the converted JAX state, exactly."""
    argv = make_argv(ncc_run["tmp"], "ncc")
    task = VxmTask(parse(TrainOptions, argv + ["--continue_train"]))
    assert task.save_dir == ncc_run["jax_dir"]
    task.setup(task.opt)
    assert task.step == ncc_run["step"] == STEPS
    want = convert.netR_state_from_jax(ncc_run["params"], ENC, DEC)
    sd = task.engine.netR.state_dict()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    mu, nu = (convert.netR_state_from_jax(ncc_run[m], ENC, DEC)
              for m in ("mu", "nu"))
    state = task.engine.optimizer.state_dict()["state"]
    names = [k for k, _ in task.engine.netR.named_parameters()]
    assert len(state) == len(names)
    for i, k in enumerate(names):
        assert float(state[i]["step"]) == ncc_run["count"] == STEPS
        assert torch.equal(state[i]["exp_avg"], mu[k]), k
        assert torch.equal(state[i]["exp_avg_sq"], nu[k]), k


def full_state(task):
    sd = {k: v.clone() for k, v in task.engine.netR.state_dict().items()}
    for i, st in task.engine.optimizer.state_dict()["state"].items():
        sd.update({f"adam.{i}.{k}": v.clone() for k, v in st.items()})
    return sd


def test_resume_is_exact(tmp_path):
    steps = [port_batch(b) for b in batches(1)]
    uninterrupted = VxmTask(parse(TrainOptions, make_argv(tmp_path, "run")))
    for b in steps[:2]:
        uninterrupted.set_input(b)
        uninterrupted.optimize_parameters()
    uninterrupted.save_networks("latest")
    uninterrupted.set_input(steps[2])
    uninterrupted.optimize_parameters()

    resumed = VxmTask(parse(TrainOptions, make_argv(
        tmp_path, "run", ["--continue_train", "--seed", "9"])))
    resumed.setup(resumed.opt)
    assert resumed.step == 2
    resumed.set_input(steps[2])
    resumed.optimize_parameters()
    assert resumed.step == 3
    mine, ref = full_state(resumed), full_state(uninterrupted)
    assert mine.keys() == ref.keys() and len(mine) > 20
    for k in ref:
        assert torch.equal(mine[k], ref[k]), k
    assert resumed.get_current_losses() == uninterrupted.get_current_losses()
