"""The 3-D ``VxmEngine``'s train step with its volumes split along D (JAX's
``spatial`` mesh axis, dfmir_tpu_torch/parallel/mesh.py) over ``gloo``
ranks on the CPU, against the JAX engine's single-device ``train_step`` on
the whole batch, at tests/test_vxm3d.py's sharded config (vol 16, enc (4,
8), dec (8, 4, 4), 3 integration steps, global B=2) with the JAX weights
carried over, the flow head scaled by ``GAIN`` in both (so that the warps
move voxels across the slabs' edges), on the (n_data, n_spatial) meshes
(1, 2), (1, 4) and (2, 2), both image losses, one ``bidir`` case and one
``remat`` case (JAX's step without remat: the same math).  JAX's own bars
(tests/test_vxm3d.py's sharded tests): total 1e-5 relative, parameters
after the step atol 1e-5, rtol 1e-4.  The ranks hold their parameters and
Adam state bit for bit alike after the step.  One launch of 4 ranks (a 1
x 2 mesh on its first two), in a thread beside the JAX compiles."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.vxm_engine import VxmConfig as JaxVxmConfig
from dfmir_tpu.engine.vxm_engine import VxmEngine as JaxVxmEngine
from dfmir_tpu.engine.vxm_engine import VxmState
from dfmir_tpu_torch.compat.convert import load_jax_vxm_params, to_nchw
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

B = 2
CFG = dict(ndims=3, vol_size=16, enc=(4, 8), dec=(8, 4, 4), int_steps=3,
           batch_size=B)
GAIN = 1e5              # the flow head N(0, 1e-5) -> N(0, 1): ~1 voxel
LIMIT = 300.0
# name: (n_data, n_spatial, VxmConfig fields beside CFG)
CASES = {"1x2-mse": (1, 2, dict(image_loss="mse")),
         "1x2-ncc": (1, 2, dict(image_loss="ncc")),
         "1x2-ncc-bidir": (1, 2, dict(image_loss="ncc", bidir=True)),
         "1x4-mse": (1, 4, dict(image_loss="mse")),
         "1x4-ncc": (1, 4, dict(image_loss="ncc")),
         "2x2-mse": (2, 2, dict(image_loss="mse")),
         "2x2-ncc": (2, 2, dict(image_loss="ncc")),
         "2x2-mse-remat": (2, 2, dict(image_loss="mse", remat=True))}


def jax_fields(fields):
    """JAX's engine for a case: remat changes memory, not the step."""
    return {k: v for k, v in fields.items() if k != "remat"}


def scaled_params(jeng):
    """JAX's initial params (numpy) with the flow head times ``GAIN``."""
    params = jax.tree.map(np.asarray, jeng.init_state(
        jax.random.PRNGKey(0)).params)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * np.float32(GAIN)
        if jax.tree_util.keystr(path).endswith("['flow']['kernel']") else x,
        params)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(2)
    a, b = (rng.random((B, 16, 16, 16, 1)).astype(np.float32)
            for _ in range(2))
    batch = (torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b)))
    out = {"a": a, "b": b, "engines": {}}
    params = None
    cases = []
    for name, (n_data, n_spatial, fields) in CASES.items():
        key = tuple(sorted(jax_fields(fields).items()))
        if key not in out["engines"]:
            jeng = JaxVxmEngine(JaxVxmConfig(**CFG, **jax_fields(fields)))
            if params is None:
                params = scaled_params(jeng)
            out["engines"][key] = jeng
        port = VxmEngine(VxmConfig(**CFG, **fields), device="cpu")
        load_jax_vxm_params(port, params)
        out[name] = {"key": key, "start": port.netR.state_dict()}
        cases.append((name, "vxm_spatial_steps", {
            "job": dict(cfg=dict(CFG, **fields), n_data=n_data,
                        n_spatial=n_spatial,
                        state={"R": port.netR.state_dict()},
                        batches=[batch])}))
    out["params"] = params

    pool = concurrent.futures.ThreadPoolExecutor(1)
    out["future"] = pool.submit(launch, checks.run_cases, ["cpu"] * 4,
                                (cases,), LIMIT)
    yield out
    pool.shutdown(wait=True)


@pytest.mark.parametrize("case", CASES)
def test_step_matches_jax_single_device(setup, case):
    n_data, n_spatial, fields = CASES[case]
    jeng = setup["engines"][setup[case]["key"]]
    params = jax.tree.map(jnp.asarray, setup["params"])
    state = VxmState(params=params, opt_state=jeng.tx.init(params),
                     step=jnp.zeros((), jnp.int32))
    st, jmetrics = jeng.train_step(state, jnp.asarray(setup["a"]),
                                   jnp.asarray(setup["b"]))
    want = VxmEngine(VxmConfig(**CFG, **fields), device="cpu")
    load_jax_vxm_params(want, jax.tree.map(np.asarray, st.params))
    ranks = setup["future"].result(timeout=LIMIT + 60)
    rep = [r[case] for r in ranks if r[case].get("in_mesh", True)]
    assert len(rep) == n_data * n_spatial
    for r in rep[1:]:
        assert torch.equal(rep[0]["checksums"][0], r["checksums"][0])
    for r in rep:
        assert r["bytes_sent"][0]["halo"] > 0, r["bytes_sent"]
        assert r["bytes_sent"][0]["gather"] > 0, r["bytes_sent"]
    for k in ("total", "sim", "smooth"):
        got, ref = rep[0]["metrics"][0][k], float(jmetrics[k])
        assert abs(got - ref) <= 1e-5 * abs(ref), (k, got, ref)
    moved = False
    for name, p in want.netR.named_parameters():
        mine = rep[0]["params"]["R"][name]
        np.testing.assert_allclose(mine.numpy(), p.detach().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
        moved |= not torch.equal(mine, setup[case]["start"][name])
    assert moved
