"""The 3-D ``VxmEngine``'s ``register``, ``eval_step`` and ``flow_stats``
with their volumes split along D (JAX's ``spatial`` mesh axis) over
``gloo`` ranks on the CPU, against the JAX engine's single-device functions
on the whole batch, at tests/test_vxm3d.py's sharded config (global B=2)
with the JAX weights carried over and the flow head scaled by ``GAIN``
(test_torch_spatial_train.py's): each rank returns its slabs of
``register``'s (y_source, pos_flow), put back together here and held to
JAX's within atol 1e-5 (JAX's bar, tests/test_vxm3d.py), and the global
metrics and field statistics within 1e-5 relative, on the (n_data,
n_spatial) meshes (1, 2), (1, 4) and (2, 2), both image losses and one
``bidir`` case.  One launch of 4 ranks (a 1 x 2 mesh on its first
two), in a thread beside the JAX compiles."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.vxm_engine import VxmConfig as JaxVxmConfig
from dfmir_tpu.engine.vxm_engine import VxmEngine as JaxVxmEngine
from dfmir_tpu_torch.compat.convert import (load_jax_vxm_params, to_nchw,
                                            to_nhwc)
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_spatial_train import CFG, scaled_params
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

B = CFG["batch_size"]
LIMIT = 300.0
# name: (n_data, n_spatial, VxmConfig fields beside CFG); each mesh's first
# case also reports register and flow_stats
CASES = {"1x2-mse": (1, 2, dict(image_loss="mse")),
         "1x2-ncc-bidir": (1, 2, dict(image_loss="ncc", bidir=True)),
         "1x4-ncc": (1, 4, dict(image_loss="ncc")),
         "2x2-ncc": (2, 2, dict(image_loss="ncc"))}
MESHES = {"1x2": "1x2-mse", "1x4": "1x4-ncc", "2x2": "2x2-ncc"}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    a, b = (rng.random((B, 16, 16, 16, 1)).astype(np.float32)
            for _ in range(2))
    batch = (torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b)))
    out = {"a": jnp.asarray(a), "b": jnp.asarray(b), "engines": {}}
    params = None
    cases = []
    for name, (n_data, n_spatial, fields) in CASES.items():
        jeng = JaxVxmEngine(JaxVxmConfig(**CFG, **fields))
        if params is None:
            params = scaled_params(jeng)
        out["engines"][name] = jeng
        port = VxmEngine(VxmConfig(**CFG, **fields), device="cpu")
        load_jax_vxm_params(port, params)
        cases.append((name, "vxm_spatial_steps", {
            "job": dict(cfg=dict(CFG, **fields), n_data=n_data,
                        n_spatial=n_spatial,
                        state={"R": port.netR.state_dict()}, batches=[],
                        register=batch, eval=True, stats=True)}))
    out["params"] = jax.tree.map(jnp.asarray, params)

    pool = concurrent.futures.ThreadPoolExecutor(1)
    out["future"] = pool.submit(launch, checks.run_cases, ["cpu"] * 4,
                                (cases,), LIMIT)
    yield out
    pool.shutdown(wait=True)


def reports(setup, case):
    """The reports of the case's mesh's ranks (the launch's first)."""
    ranks = setup["future"].result(timeout=LIMIT + 60)
    return [r[case] for r in ranks if r[case].get("in_mesh", True)]


def assembled(reps, i):
    """The ranks' slabs of ``register``'s output i, put back together:
    along D in spatial order, the data ranks along the batch."""
    n_data = 1 + max(r["data_rank"] for r in reps)
    return torch.cat([
        torch.cat([r["register"][i] for r in sorted(
            reps, key=lambda q: q["spatial_rank"]) if r["data_rank"] == d],
            dim=2) for d in range(n_data)])


@pytest.mark.parametrize("mesh", MESHES)
def test_register_matches_jax_single_device(setup, mesh):
    case = MESHES[mesh]
    want = setup["engines"][case].register(setup["params"], setup["a"],
                                           setup["b"])
    reps = reports(setup, case)
    for i, ref in enumerate(want):
        got = to_nhwc(assembled(reps, i))
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    # the flows reach across the slabs' edges
    assert float(np.abs(np.asarray(want[1])).max()) > 0.5


@pytest.mark.parametrize("mesh", MESHES)
def test_flow_stats_match_jax_single_device(setup, mesh):
    case = MESHES[mesh]
    want = setup["engines"][case].flow_stats(setup["params"], setup["a"],
                                             setup["b"])
    for r in reports(setup, case):
        for k, ref in want.items():
            got, ref = float(r["stats"][k]), float(ref)
            assert abs(got - ref) <= 1e-5 * abs(ref) + 1e-7, (k, got, ref)


@pytest.mark.parametrize("case", CASES)
def test_eval_step_matches_jax_single_device(setup, case):
    want = setup["engines"][case].eval_step(setup["params"], setup["a"],
                                            setup["b"])
    for r in reports(setup, case):
        for k, ref in want.items():
            got, ref = float(r["eval"][k]), float(ref)
            assert abs(got - ref) <= 1e-5 * abs(ref), (k, got, ref)
