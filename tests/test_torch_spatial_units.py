"""The spatial mesh axis's pieces (dfmir_tpu_torch/parallel/mesh.py and the
slab forms in ops/ and losses/), each on its slab over ``gloo`` ranks on
the CPU, against the plain whole-tensor op in one process, in float64:
``halo_exchange`` and ``gather_slabs`` with their backwards (integer
values: exact), the slab resizes, NCC, MSE and ``grad_loss`` with their
gradients (each rank's ``world`` times its share: 1e-12), ``jacobian_det``
(its rows bit for bit) and ``field_stats``; one launch of 4 ranks for the
meshes (1, 4), (2, 2) and (1, 2), the last on the launch's first two
ranks (JAX's ``make_mesh`` over the first devices).  In one process:
``slab_slice`` against JAX's ``shard_batch(..., shard_spatial=True)``, a
halo's sends and receives going out as one batch, the slab warp's plain
version and its autograd wiring bit-equal to the whole warp's rows, the
CUDA launchers' refusals, and the refusal of a depth that does not split.
With ``n_spatial=1`` the spatial rank function is the data-parallel
step (``vxm_steps``), bit for bit."""

import concurrent.futures

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dfmir_tpu.parallel import make_mesh as jax_make_mesh
from dfmir_tpu.parallel import shard_batch
from dfmir_tpu_torch.engine.vxm_engine import (VxmConfig, VxmEngine,
                                               check_slabs)
from dfmir_tpu_torch.losses.regularizers import grad_loss
from dfmir_tpu_torch.losses.similarity import mse_loss, ncc_loss
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.integrate import resize_flow
from dfmir_tpu_torch.ops.jacobian import field_stats, jacobian_det
from dfmir_tpu_torch.ops.warp import warp, warp_bwd_plain
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.parallel import mesh as mesh_mod
from dfmir_tpu_torch.parallel.mesh import (Mesh, batch_slice, halo_exchange,
                                           slab_slice)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 240.0
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "1x2": (1, 2)}
WORLD = 4
B, C, S = 2, 2, 16
LOHI = (2, 1)
SMALL = dict(ndims=3, vol_size=16, enc=(4, 8), dec=(8, 4, 4), int_steps=3)


def volumes():
    """The global tensors ``checks.spatial_pieces`` slices, float64."""
    g = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=g).double()

    def smooth(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    out = {"x": ints(B, C, S, 6, 5), "halo_lohi": LOHI,
           "flow": smooth(B, 3, S, 8, 6) * 0.6,
           "flow2": smooth(B, 3, S // 2, 4, 3),
           "g_down": smooth(B, 3, S // 2, 4, 3),
           "g_up": smooth(B, 3, S, 8, 6),
           "pred": torch.rand((B, 1, S, 7, 6), generator=g,
                              dtype=torch.float64),
           "target": torch.rand((B, 1, S, 7, 6), generator=g,
                                dtype=torch.float64)}
    for name, (_, n) in MESHES.items():
        k = S // n
        out[f"halo_w_{n}"] = ints(B, C, n * (k + sum(LOHI)), 6, 5)
        out[f"gather_w_{n}"] = ints(n, B, C, S, 6, 5)
    return out


@pytest.fixture(scope="module")
def ranks():
    vols = volumes()
    cases = []
    for name, (n_data, n) in MESHES.items():
        v = dict(vols, halo_w=vols[f"halo_w_{n}"],
                 gather_w=vols[f"gather_w_{n}"])
        cases.append((name, "spatial_pieces", {"n_data": n_data,
                                               "n_spatial": n, "vols": v}))
    rng = np.random.default_rng(3)
    A, Bv = (torch.from_numpy(rng.random((4, 1, S, S, S)).astype(np.float32))
             for _ in range(2))
    job = dict(cfg=SMALL, seed=0, flow_gain=1e5, batches=[(A, Bv)] * 2)
    cases += [("dp", "vxm_steps", {"job": job}),
              ("dp1", "vxm_spatial_steps", {"job": dict(job, n_spatial=1)})]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * WORLD,
                         (cases,), LIMIT)
    yield vols, future
    pool.shutdown(wait=True)


def all_reports(ranks, name):
    return [r[name] for r in ranks[1].result(timeout=LIMIT + 60)]


def reports(ranks, name):
    """The reports of the mesh's ranks (a rank past it reports nothing)."""
    return [r for r in all_reports(ranks, name) if r.get("in_mesh", True)]


def whole(reps, key, i, batch=True):
    """The ranks' ``key`` tensors (item i) put back together: slabs along D
    in spatial order, data ranks along the batch."""
    n_data = 1 + max(r["data_rank"] for r in reps)
    rows = [torch.cat([r[key][i] for r in sorted(reps, key=lambda q:
                                                 q["spatial_rank"])
                       if r["data_rank"] == d], dim=2)
            for d in range(n_data)]
    return torch.cat(rows) if batch else rows


@pytest.mark.parametrize("mesh", MESHES)
def test_groups_follow_jax_reshape_order(ranks, mesh):
    """The mesh is the launch's first n_data * n_spatial ranks in JAX's
    ``reshape(n_data, n_spatial)`` order; the ranks past it sit out."""
    n_data, n = MESHES[mesh]
    got = all_reports(ranks, mesh)
    assert [r.get("in_mesh", True) for r in got] == [
        rank < n_data * n for rank in range(WORLD)]
    for rank, r in enumerate(reports(ranks, mesh)):
        d, s = divmod(rank, n)
        assert (r["data_rank"], r["spatial_rank"]) == (d, s)
        assert r["spatial_group"] == [d * n + q for q in range(n)]


@pytest.mark.parametrize("mesh", MESHES)
def test_halo_and_gather_with_their_backwards(ranks, mesh):
    vols, n = ranks[0], MESHES[mesh][1]
    reps = reports(ranks, mesh)
    lo, hi = LOHI
    k = S // n
    span = k + lo + hi
    x = vols["x"].clone().requires_grad_(True)
    padded = F.pad(x, (0, 0, 0, 0, lo, hi))
    w = vols[f"halo_w_{n}"]
    f = sum((padded[:, :, s * k:s * k + span]
             * w[:, :, s * span:(s + 1) * span]).sum() for s in range(n))
    f.backward()
    windows = torch.cat([padded[:, :, s * k:s * k + span]
                         for s in range(n)], dim=2).detach()
    assert torch.equal(whole(reps, "halo", 0), windows)
    assert torch.equal(whole(reps, "halo", 1), x.grad)
    for r in reps:
        assert torch.equal(r["gather"][0], batch_slice(
            vols["x"], r["data_rank"], MESHES[mesh][0]))
    want = vols[f"gather_w_{n}"].sum(0)
    assert torch.equal(whole(reps, "gather", 1), want)


@pytest.mark.parametrize("mesh", MESHES)
def test_slab_resizes_match_the_whole_resize(ranks, mesh):
    vols, (n_data, n) = ranks[0], MESHES[mesh]
    reps = reports(ranks, mesh)
    flow = vols["flow"].clone().requires_grad_(True)
    down = resize_flow(flow, 0.5)
    (down * vols["g_down"]).sum().backward()
    torch.testing.assert_close(whole(reps, "down", 0), down.detach(),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(whole(reps, "down", 1), flow.grad, rtol=0,
                               atol=1e-12)
    flow2 = vols["flow2"].clone().requires_grad_(True)
    up = resize_flow(flow2, 2.0)
    (up * vols["g_up"]).sum().backward()
    torch.testing.assert_close(whole(reps, "up", 0), up.detach(), rtol=0,
                               atol=1e-12)
    # each spatial rank holds the whole half-size field: its gradient is
    # the part its own rows give, and the ranks' parts sum to the whole's
    for d in range(n_data):
        got = sum(r["up"][1] for r in reps if r["data_rank"] == d)
        torch.testing.assert_close(got, batch_slice(flow2.grad, d, n_data),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("mesh", MESHES)
def test_slab_losses_match_the_whole_volumes(ranks, mesh):
    """Each loss's value is the whole volume's and batch's on every rank,
    and each rank's gradient ``world`` times its share."""
    vols = ranks[0]
    reps = reports(ranks, mesh)
    world = len(reps)
    losses = {"ncc": lambda p: ncc_loss(p, vols["target"],
                                        kernel_var=[5] * 3),
              "mse": lambda p: mse_loss(p, vols["target"]),
              "grad_l1": lambda f: grad_loss(f, "l1"),
              "grad_l2": lambda f: grad_loss(f, "l2")}
    for name, fn in losses.items():
        x = vols["pred" if name in ("ncc", "mse") else "flow"].clone()
        x.requires_grad_(True)
        loss = fn(x)
        loss.backward()
        for r in reps:
            torch.testing.assert_close(r[name][0], loss.detach(), rtol=1e-12,
                                       atol=0, msg=name)
        torch.testing.assert_close(whole(reps, name, 1) / world, x.grad,
                                   rtol=0, atol=1e-12, msg=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_slab_jacobian_and_field_stats(ranks, mesh):
    vols = ranks[0]
    reps = reports(ranks, mesh)
    det = jacobian_det(vols["flow"])
    # (B, D, H, W): D is axis 1
    rows = whole([dict(r, det=[r["det"].unsqueeze(1)]) for r in reps],
                 "det", 0)
    assert torch.equal(rows.squeeze(1), det)
    want = field_stats(vols["flow"])
    for r in reps:
        for k, v in want.items():
            # the folding fraction is a float32 mean (of the ranks' means)
            torch.testing.assert_close(r["stats"][k], v, atol=0, msg=k,
                                       rtol=1e-6 if k == "fold" else 1e-12)


def test_one_spatial_rank_is_the_data_parallel_step(ranks):
    """``make_mesh(n_spatial=1)`` is the launch's mesh: the spatial rank
    function steps as ``vxm_steps`` does, bit for bit."""
    for dp, dp1 in zip(reports(ranks, "dp"), reports(ranks, "dp1")):
        assert dp["metrics"] == dp1["metrics"]
        for x, y in zip(dp["checksums"], dp1["checksums"]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("spatial_rank", [0, 1, 2])
def test_halo_sends_and_receives_in_one_batch(monkeypatch, spatial_rank):
    """A halo's receives and sends go out as one ``batch_isend_irecv``
    (posted one by one, NCCL would queue each rank's sends behind receives
    that wait on them): the planes below to the rank below, those above to
    the rank above, each direction with its own tag, nothing past an end;
    the bytes sent counted."""
    batches = []

    class Done:
        def wait(self):
            pass

    def op(fn, tensor, peer, group, tag):
        return (fn.__name__, peer, tag, tuple(tensor.shape))

    def batch(ops):
        batches.append(ops)
        return [Done() for _ in ops]
    monkeypatch.setattr(mesh_mod.dist, "P2POp", op)
    monkeypatch.setattr(mesh_mod.dist, "batch_isend_irecv", batch)
    mesh = Mesh(rank=3 + spatial_rank, world=6, device=torch.device("cpu"),
                backend="gloo", n_spatial=3)
    x = torch.zeros(1, 2, 5, 3, 3)
    mesh_mod.reset_exchange_counts()
    y = halo_exchange(x, 2, 1, mesh)
    assert y.shape == (1, 2, 8, 3, 3)
    below, above = spatial_rank > 0, spatial_rank < 2
    want = ([("irecv", 3 + spatial_rank - 1, 1, (1, 2, 2, 3, 3))] * below
            + [("irecv", 3 + spatial_rank + 1, 2, (1, 2, 1, 3, 3))] * above
            + [("isend", 3 + spatial_rank - 1, 2, (1, 2, 1, 3, 3))] * below
            + [("isend", 3 + spatial_rank + 1, 1, (1, 2, 2, 3, 3))] * above)
    assert batches == [want]
    assert mesh_mod.BYTES_SENT["halo"] == 4 * 18 * (below + 2 * above)


def test_slab_slice_is_shard_spatial():
    """``slab_slice(batch_slice(x))`` is JAX's shard of a (data 2, spatial
    4) mesh with ``shard_spatial=True`` (axis 1 of (B, D, H, W, C), axis 2
    of the port's (B, C, D, H, W))."""
    x = np.random.default_rng(0).standard_normal((4, 8, 3, 2, 1)).astype(
        np.float32)
    mesh = jax_make_mesh(n_data=2, n_spatial=4, devices=jax.devices()[:8])
    arr = shard_batch(mesh, jnp.asarray(x), ndims=3, shard_spatial=True)
    t = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    for rank, dev in enumerate(mesh.devices.flat):
        d, s = divmod(rank, 4)
        shard, = [q for q in arr.addressable_shards if q.device == dev]
        mine = slab_slice(batch_slice(t, d, 2), s, 4)
        np.testing.assert_array_equal(mine.permute(0, 2, 3, 4, 1).numpy(),
                                      np.asarray(shard.data))
    with pytest.raises(ValueError, match="do not divide"):
        slab_slice(t[:, :, :7], 0, 4)


def slab_case(z0, d=4):
    g = torch.Generator().manual_seed(z0)
    src = torch.randn((2, 2, 12, 7, 9), generator=g)
    flow = torch.randn((2, 3, 12, 7, 9), generator=g) * 2.5
    gout = torch.randn((2, 2, 12, 7, 9), generator=g)
    rows = slice(z0, z0 + d)
    return src, flow, gout, rows


@pytest.mark.parametrize("z0", [0, 4, 8])
def test_slab_warp_plain_is_the_whole_warps_rows(z0):
    """The plain slab warp and its flow gradient (B3's and B4's plain
    versions with ``z0``) equal the whole volume's rows bit for bit."""
    src, flow, g, rows = slab_case(z0)
    assert torch.equal(warp(src, flow[:, :, rows], impl="torch", z0=z0),
                       warp(src, flow, impl="torch")[:, :, rows])
    _, dflow = warp_bwd_plain(src, flow, g, need_dsrc=False)
    _, mine = warp_bwd_plain(src, flow[:, :, rows].contiguous(),
                             g[:, :, rows].contiguous(), need_dsrc=False,
                             z0=z0)
    assert torch.equal(mine, dflow[:, :, rows])


def test_slab_warp_function_launches_b3_and_b4(monkeypatch):
    """``warp(..., z0=)`` on a CUDA tensor goes through
    ``Warp3dSlabFunction``: B3 forward, B4 backward, the slab arguments
    passed on (the launchers swapped for their plain versions here)."""
    calls = []

    def fwd(s, f, z0=0):
        calls.append(("fwd", z0))
        return warp(s, f, impl="torch", z0=z0)

    def dflow(s, f, g, z0=0):
        calls.append(("dflow", z0))
        return warp_bwd_plain(s, f, g, need_dsrc=False, z0=z0)[1]

    monkeypatch.setattr(warp_cuda, "warp3d_cuda", fwd)
    monkeypatch.setattr(warp_cuda, "warp3d_bwd_dflow_cuda", dflow)
    src, flow, g, rows = slab_case(4)
    f = flow[:, :, rows].clone().requires_grad_(True)
    out = warp(src, f, impl="cuda", z0=4)
    out.backward(g[:, :, rows])
    assert calls == [("fwd", 4), ("dflow", 4)]
    assert torch.equal(out, warp(src, flow, impl="torch")[:, :, rows])
    with pytest.raises(ValueError, match="B5 has no slab form"):
        warp(src.requires_grad_(True), f, impl="cuda", z0=4)


def test_slab_launchers_refuse_what_the_kernels_do_not_take():
    src, flow, g, rows = slab_case(4)
    slab = flow[:, :, rows].contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.warp3d_cuda(src, slab, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.warp3d_bwd_dflow_cuda(src, slab, g[:, :, rows], 4)


def test_a_depth_that_does_not_split_is_refused():
    """D must be divisible by n_spatial * lcm(2^len(enc), int_downsize):
    JAX's test config splits over 4 ranks and VxmConfig() at 160^3 over 2,
    not over 4; the engine refuses before any collective."""
    check_slabs(16, 4, VxmConfig(**SMALL))
    check_slabs(160, 2, VxmConfig())
    rule = r"n_spatial \* lcm\(2\^len\(enc\), int_downsize\)"
    with pytest.raises(ValueError, match=rule):
        check_slabs(160, 4, VxmConfig())
    eng = VxmEngine(VxmConfig(**dict(SMALL, vol_size=24)), device="cpu")
    fake = Mesh(rank=0, world=4, device=torch.device("cpu"), backend="gloo",
                n_spatial=4)
    with pytest.raises(ValueError, match=rule):
        eng.data_parallel(fake)
    eng.mesh = fake
    a = torch.rand(1, 1, 6, 16, 16)           # a slab of a 24-plane volume
    for call in (eng.register, eng.eval_step, eng.flow_stats,
                 eng.train_step):
        with pytest.raises(ValueError, match=rule):
            call(a, a)
