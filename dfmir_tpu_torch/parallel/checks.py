"""The rank side of the data-parallel checks: what ``tests/test_torch_*``
and ``chip_smoke.py`` run in each rank of a ``launch``, returning host data
to compare with one process.

- ``registration_steps`` / ``vxm_steps``: build the model from a config
  and a seed or a state dict, go data parallel, take train steps on this
  rank's slice of each global batch, and report each step's metrics
  (averaged over the ranks), host ms, kernel launches and a checksum of
  the parameters and Adam state; rank 0 also the gradients (after the
  all-reduce) and the parameters after a chosen step.  With ``mesh=None``
  they run the same steps in one process on ``job["device"]`` (the card
  unless the job names another), the whole batch: the reference the ranks
  are held to.
- ``vxm_spatial_steps``: ``vxm_steps`` over a (data, spatial) mesh, each
  rank on its slab of its items, with ``register``, ``eval_step`` and
  ``flow_stats`` before the steps.
- ``spatial_pieces``: the spatial exchanges and the losses' slab forms
  alone, each on this rank's slab.
- ``run_cases``: several named cases in one launch (the functions below
  and the two above), so that a test file starts its ranks once.
- ``fail`` and ``hang``: a rank that raises, and a rank whose peer never
  joins its collective.

Nothing here imports JAX: a launch pickles these functions by name.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
import torch.distributed as dist

from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.losses.nce import patch_nce_loss
from dfmir_tpu_torch.nets.resnet_gen import Dropout
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.jacobian import field_stats
from dfmir_tpu_torch.parallel import mesh as dp


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _float32(device):
    """TF32 off for the steps alone: float32 against float32 (a spawned
    rank starts with torch's default, TF32 convolutions)."""
    flags = [(torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cuda.matmul, "allow_tf32")]
    saved = [getattr(mod, name) for mod, name in flags]
    try:
        if device.type == "cuda":
            for mod, name in flags:
                setattr(mod, name, False)
        yield
    finally:
        for (mod, name), value in zip(flags, saved):
            setattr(mod, name, value)


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _named(nets: Dict[str, torch.nn.Module], attr: str):
    """{net: {param name: the parameter's ``attr`` (data or grad)}}."""
    return {name: {k: getattr(p, attr).detach().clone().cpu()
                   for k, p in net.named_parameters()
                   if getattr(p, attr) is not None}
            for name, net in nets.items()}


def _where(mesh, job):
    """(device, rank, world): a rank's, or one process's on
    ``job["device"]`` (the card unless it names another,
    ``resolve_device``)."""
    if mesh is None:
        return resolve_device(job.get("device")), 0, 1
    return mesh.device, mesh.rank, mesh.world


def _steps(mesh, model, nets, step_fn, job, share=None, out=None):
    """Run ``step_fn(i, a, b)`` on this rank's slice of each global batch
    of ``job["batches"]`` (``share(x)``: this rank's part of a global
    tensor; ``batch_slice`` by default); the report of
    ``registration_steps``, added to ``out``."""
    dev, rank, world = _where(mesh, job)
    if share is None:
        def share(x):
            return dp.batch_slice(x, rank, world)
    dtype = getattr(torch, job.get("dtype", "float32"))
    snap = job.get("snapshot", 0)
    out = dict(out or {}, rank=rank, metrics=[], ms=[], launches=[],
               checksums=[], bytes_sent=[], exchange_s=[])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i, (A, B) in enumerate(job["batches"]):
        a, b = (share(x).to(dev, dtype) for x in (A, B))
        _sync(dev)
        warp_cuda.reset_launches()
        dp.reset_exchange_counts()
        t0 = time.perf_counter()
        metrics = step_fn(i, a, b)
        _sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["bytes_sent"].append(dict(dp.BYTES_SENT))
        out["exchange_s"].append(dict(dp.EXCHANGE_S))
        out["launches"].append(dict(warp_cuda.LAUNCHES))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["checksums"].append(dp.checksum(model.state_tensors()).cpu())
        if i == snap and rank == 0:
            out["grads"] = _named(nets, "grad")
            out["params"] = _named(nets, "data")
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    return out


def _registration_model(mesh, job):
    """(model, {net name: module}) as ``registration_steps`` builds it,
    data parallel on ``mesh``."""
    dev, _, _ = _where(mesh, job)
    cfg = RegistrationConfig(**job["cfg"])
    model = RegistrationModel(
        cfg, device=dev, generator=torch.Generator().manual_seed(
            job.get("seed", 0)))
    nets = {"G": model.netG, "F": model.netF, "R": model.netR}
    if model.netD is not None:
        nets["D"] = model.netD
    with torch.no_grad():
        for name, sd in job.get("state", {}).items():
            nets[name].load_state_dict(sd, strict=True)
        model.netR.flow.weight.mul_(job.get("flow_gain", 1.0))
    for net in nets.values():
        net.to(getattr(torch, job.get("dtype", "float32")))
    if mesh is not None:
        model.data_parallel(mesh)
    return model, nets


def registration_steps(mesh, job):
    """Data-parallel ``RegistrationModel.train_step``s.

    job: ``cfg`` (RegistrationConfig fields), ``seed`` (the weights and
    ``patch_generator``), optional ``state`` ({"G", "F", "R"[, "D"]}:
    state dicts in place of the seed's weights) and ``flow_gain`` (the
    flow head scaled), ``dtype``, ``batches`` ([(A, B)]: global batches on
    the host), ``lr`` (one rate, or one a step), ``patch_ids`` / ``flip``
    (one a step, or None), ``patch_seed`` (the ids drawn from a generator
    of that seed, else from the model's own), ``snapshot`` (the step after
    which rank 0 reports gradients and parameters), ``record_dropout``
    (report the masks' keep counts and a fingerprint), ``register`` (rank
    0 registers the last global batch after the steps), ``device`` (one
    process's, with ``mesh=None``).  TF32 is off during the steps."""
    dev, rank, _ = _where(mesh, job)
    dtype = getattr(torch, job.get("dtype", "float32"))
    model, nets = _registration_model(mesh, job)

    n = len(job["batches"])
    lrs = job["lr"] if isinstance(job["lr"], (list, tuple)) else [job["lr"]] * n
    ids = job.get("patch_ids") or [None] * n
    flips = job.get("flip") or [None] * n
    gen = (torch.Generator().manual_seed(job["patch_seed"])
           if job.get("patch_seed") is not None else None)

    def step(i, a, b):
        return model.train_step(a, b, lrs[i], patch_ids=ids[i],
                                generator=gen, flip=flips[i])

    masks = []
    handles = []
    if job.get("record_dropout"):
        def hook(module, args, out):
            live = args[0] != 0          # the ReLU before zeroes about half
            masks.append((out[live] != 0).flatten().cpu())
        handles = [m.register_forward_hook(hook)
                   for m in model.netG.modules() if isinstance(m, Dropout)]
    with _float32(dev):
        try:
            out = _steps(mesh, model, nets, step, job)
        finally:
            for h in handles:
                h.remove()
        if job.get("register") and rank == 0:
            A, B = job["batches"][-1]
            out["register"] = _host(model.register(A.to(dev, dtype),
                                                   B.to(dev, dtype)))
    out["patch_state"] = model.patch_generator.get_state()
    if masks:
        kept = torch.cat(masks)
        out["dropout"] = {"draws": kept.numel(), "kept": int(kept.sum()),
                          "head": kept[:4096].clone()}
    return out


def vxm_steps(mesh, job):
    """Data-parallel ``VxmEngine.train_step``s: job as
    ``registration_steps``'s (``cfg`` VxmConfig fields, ``state`` {"R"},
    ``lr`` None for ``cfg.lr``; no patch ids, flips or dropout)."""
    dev, _, _ = _where(mesh, job)
    cfg = VxmConfig(**job["cfg"])
    eng = VxmEngine(cfg, device=dev, seed=job.get("seed", 0))
    with torch.no_grad():
        if "state" in job:
            eng.netR.load_state_dict(job["state"]["R"], strict=True)
        eng.netR.flow.weight.mul_(job.get("flow_gain", 1.0))
    eng.netR.to(getattr(torch, job.get("dtype", "float32")))
    if mesh is not None:
        eng.data_parallel(mesh)

    def step(i, a, b):
        return eng.train_step(a, b, job.get("lr"))
    with _float32(dev):
        return _steps(mesh, eng, {"R": eng.netR}, step, job)


def vxm_spatial_steps(mesh, job):
    """``vxm_steps`` with the volumes split along D as well: ``make_mesh``
    of the launch's first ``job["n_data"]`` (all ranks by default) *
    ``job["n_spatial"]`` ranks, each rank taking its data rank's items and
    its spatial rank's slab of each global batch; a rank past the mesh
    reports ``{"rank": r, "in_mesh": False}`` and nothing else.  Before the
    steps, with netR's first weights, each rank reports its slabs of
    ``register`` on ``job["register"]`` (a global (A, B), ``reg_reps``
    calls timed) and, where asked, ``eval_step`` (``job["eval"]``) and
    ``flow_stats`` (``job["stats"]``) on it, each with its launches; each
    step also reports the bytes this rank sent in the spatial exchanges.
    With ``mesh=None``: one process on the whole batch
    (``job["device"]``), the reference."""
    if mesh is not None:
        rank = mesh.rank
        mesh = dp.make_mesh(mesh, job.get("n_data"), job["n_spatial"])
        if mesh is None:
            return {"rank": rank, "in_mesh": False}
    dev, _, _ = _where(mesh, job)
    dtype = getattr(torch, job.get("dtype", "float32"))
    cfg = VxmConfig(**job["cfg"])
    eng = VxmEngine(cfg, device=dev, seed=job.get("seed", 0))
    with torch.no_grad():
        if "state" in job:
            eng.netR.load_state_dict(job["state"]["R"], strict=True)
        eng.netR.flow.weight.mul_(job.get("flow_gain", 1.0))
    if mesh is not None:
        eng.data_parallel(mesh)

        def share(x):
            return dp.slab_slice(dp.batch_slice(x, mesh.data_rank,
                                                mesh.n_data),
                                 mesh.spatial_rank, mesh.n_spatial)
    else:
        def share(x):
            return x
    out = {}
    with _float32(dev):
        if job.get("register") is not None:
            a, b = (share(x).to(dev, dtype) for x in job["register"])
            calls = {"register": lambda: eng.register(a, b)}
            if job.get("eval"):
                calls["eval"] = lambda: eng.eval_step(a, b)
            if job.get("stats"):
                calls["stats"] = lambda: eng.flow_stats(a, b)
            for name, call in calls.items():
                ms = []
                for _ in range(job.get("reg_reps", 1) if name == "register"
                               else 1):
                    _sync(dev)
                    warp_cuda.reset_launches()
                    t0 = time.perf_counter()
                    res = call()
                    _sync(dev)
                    ms.append((time.perf_counter() - t0) * 1e3)
                out[name] = _host(res)
                out[f"{name}_ms"] = ms
                out[f"{name}_launches"] = dict(warp_cuda.LAUNCHES)

        def step(i, a, b):
            return eng.train_step(a, b, job.get("lr"))
        report = _steps(mesh, eng, {"R": eng.netR}, step, job, share, out)
    if mesh is not None:
        report.update(data_rank=mesh.data_rank,
                      spatial_rank=mesh.spatial_rank)
    return report


def reduce_is_exact(mesh, job):
    """One backward of the job's first global batch (this rank's slice),
    then the step's all-reduce of the gradients: whether every gradient
    came back bit for bit as it went in (over one rank the mean is
    exact), and how many tensors it held."""
    dev, rank, world = _where(mesh, job)
    dtype = getattr(torch, job.get("dtype", "float32"))
    model, nets = _registration_model(mesh, job)
    A, B = job["batches"][0]
    a, b = (dp.batch_slice(x, rank, world).to(dev, dtype) for x in (A, B))
    gen = torch.Generator().manual_seed(job.get("patch_seed", 0))
    with _float32(dev):
        total, _, _ = model.loss_fn(a, b, generator=gen)
        total.backward()
    params = [p for net in nets.values() for p in net.parameters()
              if p.grad is not None]
    before = [p.grad.clone() for p in params]
    for net in nets.values():
        dp.all_reduce_grads(net.parameters(), mesh)
    return {"exact": all(torch.equal(p.grad, g)
                         for p, g in zip(params, before)),
            "tensors": len(params)}


# ------------------------------------------------- the collectives, alone

def collectives(mesh, flow):
    """The helpers on known tensors: rank r's gradient and metric r + 1,
    keys ``10 r + [0, 1, 2]``, ``global_mean`` of r + 1 squared,
    ``all_reduce_max`` of (r + 1, -r - 1), ``field_stats`` of this rank's
    slice of the global batch of flows ``flow``, and ``replicate`` of
    equal tensors and of r."""
    r = mesh.rank
    p = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))
    p.grad = torch.full((3,), r + 1.0, dtype=torch.float64)
    q = torch.nn.Parameter(torch.zeros(2))          # no gradient: skipped
    dp.all_reduce_grads([p, q], mesh)
    metrics = dp.all_reduce_metrics(
        {"a": torch.tensor(r + 1.0), "b": torch.tensor(-2.0 * r)}, mesh)
    gathered = dp.all_gather(torch.arange(3.0) + 10 * r, mesh)
    x = torch.tensor(r + 1.0, dtype=torch.float64, requires_grad=True)
    y = dp.global_mean(x, mesh) ** 2
    y.backward()
    biggest = dp.all_reduce_max(torch.tensor([r + 1.0, -r - 1.0]), mesh)
    stats = field_stats(dp.batch_slice(flow, r, mesh.world), mesh)
    same = torch.ones(2)
    dp.replicate([same], mesh)
    try:
        dp.replicate([torch.full((2,), float(r))], mesh)
        refused = None
    except RuntimeError as err:
        refused = str(err)
    return {"grad": p.grad, "no_grad": q.grad, "metrics": metrics,
            "gathered": gathered, "y": y.detach(), "dx": x.grad,
            "max": biggest, "stats": stats, "replicated": same,
            "refused": refused}


def nce(mesh, feat_q, feat_k, nce_T):
    """PatchNCE with all negatives on this rank's rows of the global
    (B * P, dim) features: the per-patch losses, their mean averaged over
    the ranks, and the gradient of the global mean to this rank's
    queries."""
    rows = dp.batch_slice(feat_q, mesh.rank, mesh.world)
    q = rows.clone().requires_grad_(True)
    k = dp.batch_slice(feat_k, mesh.rank, mesh.world)
    per_patch = patch_nce_loss(q, k, nce_T, all_negatives_from_minibatch=True,
                               mesh=mesh)
    loss = per_patch.mean()
    (loss / mesh.world).backward()
    mean = dp.all_reduce_metrics({"loss": loss}, mesh)["loss"]
    return {"per_patch": per_patch.detach(), "mean": mean, "grad": q.grad}


def spatial_pieces(mesh, n_spatial, vols, n_data=None):
    """The spatial exchanges and the slab forms of the losses, each on
    this rank's slab of the global tensors ``vols``, on the rank's device
    (``make_mesh`` of the launch's first ``n_data`` (all by default) *
    ``n_spatial`` ranks; each rank's share of the batch and its slab along
    D; a rank past the mesh reports ``{"in_mesh": False}``), for the tests
    to hold against the whole-tensor ops:

    - ``halo``: ``halo_exchange(x, lo, hi)`` and the gradient of x under
      ``sum(halo * w)``, w this rank's (B, C, lo + D + hi, H, W) part of
      ``vols["halo_w"]`` (the spatial ranks' windows one after another);
    - ``gather``: ``gather_slabs(x)`` and x's gradient under
      ``sum(gathered * w)``, w ``vols["gather_w"][spatial_rank]``;
    - ``down`` / ``up``: ``resize_flow_slab(flow, 1/2)`` from the slab and
      ``resize_flow_to_slab(flow2, 2)`` from the whole half-size field,
      each with its input's gradient under ``sum(out * g)``, g this rank's
      slab of ``vols["g_down"]`` / ``vols["g_up"]``;
    - ``ncc`` (window 5), ``mse`` and ``grad_l1`` / ``grad_l2``: the
      value and the gradient of the prediction / flow;
    - ``det`` and ``stats``: ``jacobian_det`` and ``field_stats`` of the
      flow's slab.

    Every gradient is this rank's: ``world`` times its true share."""
    from dfmir_tpu_torch.losses.regularizers import grad_loss
    from dfmir_tpu_torch.losses.similarity import mse_loss, ncc_loss
    from dfmir_tpu_torch.ops.integrate import (resize_flow_slab,
                                               resize_flow_to_slab)
    from dfmir_tpu_torch.ops.jacobian import jacobian_det
    mesh = dp.make_mesh(mesh, n_data, n_spatial)
    if mesh is None:
        return {"in_mesh": False}
    r, n, dev = mesh.spatial_rank, mesh.n_spatial, mesh.device

    def share(t, axis=2):
        return dp.slab_slice(dp.batch_slice(t, mesh.data_rank, mesh.n_data),
                             r, n, axis).to(dev, copy=True)

    def leaf(t):
        return share(t).requires_grad_(True)

    out = {"data_rank": mesh.data_rank, "spatial_rank": r,
           "spatial_group": dist.get_process_group_ranks(
               mesh.spatial_group)}
    lo, hi = vols["halo_lohi"]
    x = leaf(vols["x"])
    y = dp.halo_exchange(x, lo, hi, mesh)
    (y * share(vols["halo_w"])).sum().backward()
    out["halo"] = (y.detach(), x.grad)
    x = leaf(vols["x"])
    y = dp.gather_slabs(x, mesh)
    w = dp.batch_slice(vols["gather_w"][r], mesh.data_rank,
                       mesh.n_data).to(dev)
    (y * w).sum().backward()
    out["gather"] = (y.detach(), x.grad)
    f = leaf(vols["flow"])
    y = resize_flow_slab(f, 0.5, mesh)
    (y * share(vols["g_down"])).sum().backward()
    out["down"] = (y.detach(), f.grad)
    f2 = dp.batch_slice(vols["flow2"], mesh.data_rank, mesh.n_data).to(
        dev, copy=True).requires_grad_(True)
    y = resize_flow_to_slab(f2, 2.0, mesh)
    (y * share(vols["g_up"])).sum().backward()
    out["up"] = (y.detach(), f2.grad)
    for name, fn in (("ncc", lambda p, t: ncc_loss(p, t, kernel_var=[5] * 3,
                                                   mesh=mesh)),
                     ("mse", lambda p, t: mse_loss(p, t, mesh))):
        p = leaf(vols["pred"])
        loss = fn(p, share(vols["target"]))
        loss.backward()
        out[name] = (loss.detach(), p.grad)
    for penalty in ("l1", "l2"):
        f = leaf(vols["flow"])
        loss = grad_loss(f, penalty, mesh)
        loss.backward()
        out[f"grad_{penalty}"] = (loss.detach(), f.grad)
    with torch.no_grad():
        f = share(vols["flow"])
        out["det"] = jacobian_det(f, mesh)
        out["stats"] = field_stats(f, mesh)
    return out


def loader(mesh, opt, epochs):
    """This rank's batches of a sliced ``DataLoader`` over ``epochs``:
    (epoch, A, A_paths) each."""
    from dfmir_tpu_torch.data import create_dataset
    data = create_dataset(opt, mesh.rank, mesh.world)
    out = []
    for epoch in epochs:
        data.set_epoch(epoch)
        out += [(epoch, b["A"], b["A_paths"]) for b in data]
    return {"len": len(data), "batches": out}


def fail(mesh, message):
    """Rank 1 raises ``message``; rank 0 waits for it at a barrier."""
    if mesh.rank == 1:
        raise ValueError(message)
    dp.barrier(mesh)


def hang(mesh, seconds):
    """Rank 1 sleeps ``seconds`` before the barrier that rank 0 waits at:
    longer than the collective timeout, a hang."""
    if mesh.rank == 1:
        time.sleep(seconds)
    dp.barrier(mesh)


def tf32_flags(mesh):
    """The rank's TF32 flags (cuDNN, cuBLAS), as the launch left them."""
    return {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}


CASES = {f.__name__: f for f in (registration_steps, vxm_steps,
                                 vxm_spatial_steps, spatial_pieces,
                                 reduce_is_exact, collectives, nce,
                                 loader, tf32_flags)}


def run_cases(mesh, cases):
    """{name: CASES[fn](mesh, **kwargs)} for each (name, fn, kwargs)."""
    return {name: CASES[fn](mesh, **kwargs) for name, fn, kwargs in cases}
