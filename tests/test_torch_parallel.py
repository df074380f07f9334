"""Data parallelism over processes (dfmir_tpu_torch/parallel/), the JAX
package's parallel/mesh.py: ``batch_slice`` against JAX's own
``shard_batch``, and over 2 ``gloo`` ranks on the CPU (one launch for the
cases below) the sliced loader against one process over 2 epochs, the
collectives on known tensors (and the field statistics of a global batch
of flows against one process's), and PatchNCE with all negatives against
``patch_nce_loss`` on the global batch in float64 (values and query
gradients within 1e-12).  A rank that raises fails its launch with its
message; a hung collective fails its launch within its time limit."""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.parallel import make_mesh, shard_batch
from dfmir_tpu_torch.data import create_dataset
from dfmir_tpu_torch.losses import patch_nce_loss
from dfmir_tpu_torch.options import TrainOptions
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import RankFailed, launch
from dfmir_tpu_torch.ops.jacobian import field_stats
from dfmir_tpu_torch.parallel.mesh import Mesh, batch_slice, check_share
from dfmir_tpu_torch.utils.png import write_png

CPU2 = ["cpu", "cpu"]
LIMIT = 120.0            # seconds a launch may take before it fails
N_IMAGES, BATCH, EPOCHS = 6, 2, (1, 2)
NCE_B, NCE_P, NCE_DIM, NCE_T = 4, 16, 8, 0.07


@pytest.mark.parametrize("world", [2, 4])
def test_batch_slice_is_shard_batch(world):
    x = np.random.default_rng(0).standard_normal((8, 6, 5, 1)).astype(
        np.float32)
    mesh = make_mesh(n_data=world, devices=jax.devices()[:world])
    arr = shard_batch(mesh, jnp.asarray(x))
    for r, dev in enumerate(mesh.devices.flat):
        shard, = [s for s in arr.addressable_shards if s.device == dev]
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      batch_slice(x, r, world))
        np.testing.assert_array_equal(
            batch_slice(torch.from_numpy(x), r, world).numpy(),
            np.asarray(shard.data))
    with pytest.raises(ValueError, match="divide"):
        batch_slice(x[:7], 0, world)


def test_check_share_takes_only_a_ranks_share():
    """A task's set_input takes the sliced loader's share (B / world
    items) and refuses a global batch; one process takes any batch."""
    mesh = Mesh(rank=1, world=2, device=torch.device("cpu"), backend="gloo")
    check_share(2, 4, mesh)
    for n in (4, 1):
        with pytest.raises(ValueError, match=f"given {n} items"):
            check_share(n, 4, mesh)
    check_share(4, 4, None)


def loader_opt(root):
    rng = np.random.default_rng(0)
    for side in "AB":
        os.makedirs(root / f"train{side}")
        for i in range(N_IMAGES):
            write_png(str(root / f"train{side}" / f"{i:03d}.png"),
                      rng.integers(0, 256, (64, 64), dtype=np.uint8))
    argv = ["--dataroot", str(root), "--name", "p", "--checkpoints_dir",
            str(root / "ck"), "--gpu_ids", "-1", "--crop_size", "64",
            "--load_size", "64", "--batch_size", str(BATCH)]
    return TrainOptions(argv).parse()


def flows():
    """A global batch of 2-D flows, some of them folding, in float64."""
    rng = np.random.default_rng(2)
    return torch.from_numpy(1.5 * rng.standard_normal((4, 2, 12, 12)))


def nce_features():
    rng = np.random.default_rng(1)
    q, k = (rng.standard_normal((NCE_B * NCE_P, NCE_DIM)) for _ in range(2))
    q, k = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (q, k))
    return torch.from_numpy(q), torch.from_numpy(k)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of 2 gloo ranks running every case; (opt, features,
    results by rank)."""
    opt = loader_opt(tmp_path_factory.mktemp("loader"))
    q, k = nce_features()
    flow = flows()
    cases = [("loader", "loader", {"opt": opt, "epochs": EPOCHS}),
             ("collectives", "collectives", {"flow": flow}),
             ("nce", "nce", {"feat_q": q, "feat_k": k, "nce_T": NCE_T})]
    t0 = time.monotonic()
    out = launch(checks.run_cases, CPU2, args=(cases,),
                 timeout=LIMIT)
    assert time.monotonic() - t0 < LIMIT
    return opt, (q, k), flow, out


def test_sliced_loader_is_one_process_in_order(ranks):
    opt, _, _, out = ranks
    one = create_dataset(opt)
    want = []
    for epoch in EPOCHS:
        one.set_epoch(epoch)
        want += [(epoch, b["A"], b["A_paths"]) for b in one]
    got = [r["loader"]["batches"] for r in out]
    assert [r["loader"]["len"] for r in out] == [len(one)] * 2
    assert len(want) == len(EPOCHS) * (N_IMAGES // BATCH)
    assert len(got[0]) == len(got[1]) == len(want)
    for (epoch, A, paths), *parts in zip(want, *got):
        assert all(p[0] == epoch for p in parts)
        assert [len(p[1]) for p in parts] == [BATCH // 2] * 2
        np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                      A)
        assert sum((list(p[2]) for p in parts), []) == list(paths)
    # the order is the shuffled one, not the files'
    assert [p for _, _, ps in want for p in ps] != sorted(
        p for _, _, ps in want for p in ps)


def test_collectives_on_known_tensors(ranks):
    _, _, flow, out = ranks
    want = field_stats(flow)
    assert 0 < float(want["fold"]) < 1
    for r in out:
        c = r["collectives"]
        assert torch.equal(c["grad"], torch.full((3,), 1.5,
                                                 dtype=torch.float64))
        assert c["no_grad"] is None
        assert {k: float(v) for k, v in c["metrics"].items()} == {
            "a": 1.5, "b": -1.0}
        assert torch.equal(c["gathered"],
                           torch.tensor([0., 1., 2., 10., 11., 12.]))
        # global_mean: the mean's value, this rank's own gradient
        assert float(c["y"]) == 2.25 and float(c["dx"]) == 3.0
        assert torch.equal(c["max"], torch.tensor([2.0, -1.0]))
        # the field statistics of the global batch: the extremes exact,
        # the means the mean of the ranks' means
        assert list(c["stats"]) == list(want)
        for k, v in want.items():
            assert abs(float(c["stats"][k]) - float(v)) <= (
                0.0 if k in ("jac_min", "jac_max", "flow_max") else 1e-12), k
        # replicate: equal replicas go through, others fail on every rank
        assert torch.equal(c["replicated"], torch.ones(2))
        assert "ranks [1] hold other parameters" in c["refused"]


def test_all_negatives_nce_over_ranks_is_the_global_loss(ranks):
    _, (q, k), _, out = ranks
    qg = q.clone().requires_grad_(True)
    ref = patch_nce_loss(qg, k, NCE_T, all_negatives_from_minibatch=True)
    ref.mean().backward()
    rows = NCE_B * NCE_P // 2
    for r, res in enumerate(out):
        c = res["nce"]
        mine = slice(r * rows, (r + 1) * rows)
        np.testing.assert_allclose(c["per_patch"], ref.detach()[mine],
                                   rtol=0, atol=1e-12)
        assert abs(float(c["mean"]) - float(ref.detach().mean())) <= 1e-12
        np.testing.assert_allclose(c["grad"], qg.grad[mine], rtol=0,
                                   atol=1e-12)
    # without all negatives each image is its own batch: a mesh of one
    # image slice changes nothing
    per_image = patch_nce_loss(q[:rows], k[:rows], NCE_T,
                               batch_size=NCE_B // 2)
    assert torch.equal(per_image, patch_nce_loss(q, k, NCE_T,
                                                 batch_size=NCE_B)[:rows])


def test_a_rank_that_raises_fails_the_launch():
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="rank 1 of 2") as err:
        launch(checks.fail, CPU2, args=("the second rank fails",),
               timeout=LIMIT, collective_timeout=30)
    assert "ValueError: the second rank fails" in str(err.value)
    assert time.monotonic() - t0 < LIMIT


@pytest.mark.parametrize("collective_timeout,timeout,error", [
    (2.0, LIMIT, RankFailed),      # the collective's own timeout
    (LIMIT, 6.0, TimeoutError),    # the launch's time limit
])
def test_a_hung_collective_fails_within_its_limit(collective_timeout,
                                                  timeout, error):
    t0 = time.monotonic()
    with pytest.raises(error):
        launch(checks.hang, CPU2, args=(2 * LIMIT,),
               timeout=timeout, collective_timeout=collective_timeout)
    took = time.monotonic() - t0
    assert took < min(collective_timeout, timeout) + 30, took
