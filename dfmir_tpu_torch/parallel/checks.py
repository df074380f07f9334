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
- ``joint_spatial_steps``: the joint model (``RegistrationModel``) over a
  (data, spatial) mesh, each rank on its slab of its items: ``register``,
  one ``loss_fn`` with its gradients, ``eval_step``, and train steps.
- ``joint_slab_pieces``: the joint model's slab forms alone (the norms,
  pads, blurs, convs, netG's taps, the patch sampler), on this rank's
  slab; ``option_slab_pieces`` the training options' (the transposed
  conv, dropout's masks, the discriminators, the all-negatives keys, the
  bfloat16 exchanges); ``zoo_slab_pieces`` the 2-D-only generators' (the
  StyleGAN2 FIR, convs and upsampling, MUNIT's blocks, both generators
  whole).
- ``run_cases``: several named cases in one launch (the functions below
  and the two above), so that a test file starts its ranks once;
  ``one_process`` runs one of them as the one-process reference in a
  launch of one rank.
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


def _spatial_share(mesh, job):
    """(mesh, share): ``make_mesh`` of the launch's first
    ``job["n_data"]`` * ``job["n_spatial"]`` ranks (None for a rank past
    it, and for one process) and this rank's part of a global tensor: its
    data rank's items, its spatial rank's slab along axis 2."""
    if mesh is None:
        return None, lambda x: x
    mesh = dp.make_mesh(mesh, job.get("n_data"), job["n_spatial"])
    if mesh is None:
        return None, None

    def share(x):
        return dp.slab_slice(dp.batch_slice(x, mesh.data_rank, mesh.n_data),
                             mesh.spatial_rank, mesh.n_spatial)
    return mesh, share


def _timed(dev, call, reps=1):
    """(result, host ms of each call, the launches of the last)."""
    ms = []
    for _ in range(reps):
        _sync(dev)
        warp_cuda.reset_launches()
        dp.reset_exchange_counts()
        t0 = time.perf_counter()
        res = call()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return res, ms, dict(warp_cuda.LAUNCHES)


def joint_spatial_steps(mesh, job):
    """The joint model with its images split along axis 2 (H at 2-D, D
    at 3-D; JAX's ``shard_batch(..., shard_spatial=True)``) over the
    launch's first ``job["n_data"]`` * ``job["n_spatial"]`` ranks; a rank
    past the mesh reports ``{"rank": r, "in_mesh": False}``.  The model as
    ``registration_steps`` builds it (``cfg``, ``seed``, ``state``,
    ``flow_gain``), then, each on this rank's share of a global (A, B):

    - ``register`` (``reg_reps`` calls timed): this rank's slabs of
      (fake_B, idt_B, y_source, pos_flow), with ms, launches and bytes;
    - ``loss`` (a global (A, B) and ``loss_ids``): one ``loss_fn`` and
      backward, the gradients averaged over the ranks (rank 0 reports
      them, and every rank the metrics averaged over the ranks, which are
      the global ones);
    - ``eval``: ``eval_step`` with ``loss_ids`` (the global metrics);
    - ``batches``: ``train_step``s as ``registration_steps``'s (``lr``,
      ``patch_ids`` and ``flip`` one a step), with the same report (with
      ``lambda_GAN > 0`` netD's gradients and parameters too).
      ``save_after`` (i, path): after step i, save the networks and the
      Adam states to ``path`` (rank 0); ``load_after`` (i, path): after
      step i, report the parameters (rank 0, ``params_own``) and load that
      state, so that the next step starts where the run that saved it
      stood;
    - ``netD_reps`` (with ``lambda_GAN > 0``): netD's GAN loss on this
      rank's share of the first batch's real_B and its backward, timed
      (``netD_ms``; on slabs netD runs on the gathered image, the pixel
      netD on the slab), with its bytes.

    The options come with ``cfg``; ``loss_flip`` is FastCUT's coin for
    ``loss`` and ``eval``; ``dropout_seed`` s seeds the dropout masks'
    generator after ``data_parallel`` with s + d at data rank d, so that
    the ranks of data rank 0 draw what one process seeded with s draws.
    With ``mesh=None``: one process on the whole batch (``job["device"]``),
    the reference.  TF32 is off throughout."""
    rank = mesh.rank if mesh is not None else 0
    mesh, share = _spatial_share(mesh, job)
    if share is None:
        return {"rank": rank, "in_mesh": False}
    dev, _, _ = _where(mesh, job)
    model, nets = _registration_model(None, dict(job, device=dev))
    if mesh is not None:
        model.data_parallel(mesh)
    if job.get("dropout_seed") is not None:
        model.dropout_generator.manual_seed(
            job["dropout_seed"] + (0 if mesh is None else mesh.data_rank))
    flip = job.get("loss_flip")
    dtype = getattr(torch, job.get("dtype", "float32"))
    out = {}
    if mesh is not None:
        out.update(data_rank=mesh.data_rank, spatial_rank=mesh.spatial_rank)
    peak = (torch.cuda.max_memory_allocated if dev.type == "cuda"
            else lambda _: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with _float32(dev):
        if job.get("register") is not None:
            a, b = (share(x).to(dev, dtype) for x in job["register"])
            res, ms, launches = _timed(dev, lambda: model.register(a, b),
                                       job.get("reg_reps", 1))
            out.update(register=_host(res), register_ms=ms,
                       register_launches=launches,
                       register_bytes=dict(dp.BYTES_SENT),
                       register_exchange_s=dict(dp.EXCHANGE_S),
                       register_peak_bytes=peak(dev))
            del res
        if job.get("loss") is not None:
            a, b = (share(x).to(dev, dtype) for x in job["loss"])
            ids = job.get("loss_ids")

            def loss():
                model.optimizer.zero_grad(set_to_none=True)
                total, metrics, _ = model.loss_fn(a, b, patch_ids=ids,
                                                  flip=flip)
                total.backward()
                for net in nets.values():
                    dp.all_reduce_grads(net.parameters(), mesh)
                return dp.all_reduce_metrics(
                    {k: v.detach() for k, v in metrics.items()}, mesh)
            metrics, ms, launches = _timed(dev, loss)
            out.update(loss={k: float(v) for k, v in metrics.items()},
                       loss_ms=ms, loss_launches=launches)
            if rank == 0:
                out["loss_grads"] = _named(nets, "grad")
            model.optimizer.zero_grad(set_to_none=True)
        if job.get("eval"):
            a, b = (share(x).to(dev, dtype) for x in job["loss"])
            (metrics, _), ms, launches = _timed(dev, lambda: model.eval_step(
                a, b, patch_ids=job.get("loss_ids"), flip=flip))
            out.update(eval={k: float(v) for k, v in metrics.items()},
                       eval_ms=ms, eval_launches=launches)
        if job.get("batches"):
            n = len(job["batches"])
            ids = job.get("patch_ids") or [None] * n
            flips = job.get("flip") or [None] * n

            save = job.get("save_after") or (None, None)
            load = job.get("load_after") or (None, None)
            extra = {}

            opts = {"optimizer": model.optimizer,
                    "optimizer_D": model.optimizer_D}
            opts = {k: o for k, o in opts.items() if o is not None}

            def step(i, a, b):
                metrics = model.train_step(a, b, job["lr"], patch_ids=ids[i],
                                           flip=flips[i])
                if i == save[0] and rank == 0:
                    torch.save({"nets": {k: n.state_dict()
                                         for k, n in nets.items()},
                                **{k: o.state_dict()
                                   for k, o in opts.items()}}, save[1])
                if i == load[0]:
                    if rank == 0:
                        extra["params_own"] = _named(nets, "data")
                    state = torch.load(load[1], map_location=dev)
                    for k, n in nets.items():
                        n.load_state_dict(state["nets"][k])
                    for k, o in opts.items():
                        o.load_state_dict(state[k])
                return metrics
            out = _steps(mesh, model, nets, step, dict(job, device=dev),
                         share, out)
            out.update(extra)
        if job.get("netD_reps") and model.netD is not None:
            b = share(job["batches"][0][1]).to(dev, dtype)

            def d_call():
                model.optimizer_D.zero_grad(set_to_none=True)
                model._gan_loss(b, True, mesh).backward()
            _, ms, _ = _timed(dev, d_call, job["netD_reps"])
            model.optimizer_D.zero_grad(set_to_none=True)
            out.update(netD_ms=ms, netD_bytes=dict(dp.BYTES_SENT),
                       netD_exchange_s=dict(dp.EXCHANGE_S))
    out.setdefault("rank", rank)
    out.setdefault("peak_bytes", peak(dev))
    del model, nets
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def joint_slab_pieces(mesh, n_spatial, job, n_data=None):
    """The joint model's slab forms alone, each on this rank's slab of
    ``job``'s global tensors (``make_mesh`` of the first ``n_data`` *
    ``n_spatial`` ranks; a rank past the mesh reports ``{"in_mesh":
    False}``), for the tests to hold against the whole-tensor ops, each
    value with the gradient of its input under ``sum(out * w)``, w this
    rank's slab (or window) of ``job["w_<name>"]``:

    - ``norm``: ``instance_norm``; ``pad_reflect`` / ``pad_replicate``:
      ``pad_nd`` by ``job["pad"]`` (the rank's window of the padded
      image, w its window); ``down`` / ``up``: ``blur_downsample`` /
      ``blur_upsample``; ``conv``: ``conv_slab`` of ``job["conv"]`` (a
      module);
    - ``netG``: ``job["netG"]``'s output and taps ``job["layers"]`` on the
      slab of ``job["x"]`` (no gradients);
    - ``sample``: ``job["netF"]`` (PatchSampleF) on those taps with
      ``job["ids"]``, the gathered samples and the gradient of the taps'
      input under ``sum(samples * w_sample)`` (each spatial rank's loss
      the whole sum: ``n_spatial`` times the whole gradient's rows);
    - ``smooth``: ``smoothness_loss`` of the slab of ``job["flow"]`` and
      its gradient (``world`` times this rank's share);
    - ``unet_<name>`` for each ``job["unets"][name]`` = (a ``VxmUnet``,
      its global input, w): the UNet on the input's slab (its levels that
      do not split gathered), the input's gradient and the parameters'
      (this rank's part: the ranks' add up to the whole image's);
    - ``warp`` where ``job["warp"]`` = (src, flow, w): ``Warp2dSlabFunction``
      with the mesh on the slabs of both (B1 and B2's plain versions on the
      CPU), and the gradients of both."""
    from dfmir_tpu_torch.losses.regularizers import smoothness_loss
    from dfmir_tpu_torch.nets.layers import conv_slab, instance_norm, pad_nd
    from dfmir_tpu_torch.ops.filters import blur_downsample, blur_upsample
    mesh = dp.make_mesh(mesh, n_data, n_spatial)
    if mesh is None:
        return {"in_mesh": False}
    r, n = mesh.spatial_rank, mesh.n_spatial

    def share(t):
        return dp.slab_slice(dp.batch_slice(t, mesh.data_rank, mesh.n_data),
                             r, n).clone()

    def leaf(t):
        return share(t).requires_grad_(True)

    def window(t, pad):
        # this rank's rows of the whole padded tensor t: its slab and pad
        # rows each side
        t = dp.batch_slice(t, mesh.data_rank, mesh.n_data)
        k = (t.shape[2] - 2 * pad) // n
        return t.narrow(2, r * k, k + 2 * pad)

    out = {"data_rank": mesh.data_rank, "spatial_rank": r}
    x = job["x"]
    cases = {"norm": (lambda v: instance_norm(v, mesh=mesh), share),
             "down": (lambda v: blur_downsample(v, mesh=mesh), share),
             "up": (lambda v: blur_upsample(v, mesh=mesh), share),
             "conv": (lambda v: conv_slab(job["conv"], v, mesh), share)}
    for mode in ("reflect", "replicate"):
        cases[f"pad_{mode}"] = (
            lambda v, m=mode: pad_nd(v, job["pad"], m, mesh),
            lambda t: window(t, job["pad"]))
    for name, (fn, part) in cases.items():
        v = leaf(x)
        y = fn(v)
        (y * part(job[f"w_{name}"])).sum().backward()
        out[name] = (y.detach(), v.grad)
    layers = tuple(job["layers"])
    v = leaf(job["x_g"])
    y, feats = job["netG"](v, layers=layers, mesh=mesh)
    out["netG"] = (y.detach(), [f.detach() for f in feats])
    samples, ids = job["netF"](feats, job["num_patches"], job["ids"],
                               mesh=mesh,
                               tap_pads=job["netG"].tap_pads(layers))
    sum((s * w).sum() for s, w in zip(samples, job["w_sample"])).backward()
    out["sample"] = ([s.detach() for s in samples], v.grad)
    f = leaf(job["flow"])
    loss = smoothness_loss(f, mesh)
    loss.backward()
    out["smooth"] = (loss.detach(), f.grad)
    for name, (unet, x_u, w_u) in job.get("unets", {}).items():
        unet.zero_grad(set_to_none=True)
        v = leaf(x_u)
        y = unet(v, mesh)
        (y * share(w_u)).sum().backward()
        out[f"unet_{name}"] = (y.detach(), v.grad, {
            k: p.grad.clone() for k, p in unet.named_parameters()})
    if "warp" in job:
        src, flow, w = job["warp"]
        s_, f_ = leaf(src), leaf(flow)
        y = warp_cuda.Warp2dSlabFunction.apply(s_, f_, r * f_.shape[2], mesh)
        (y * share(w)).sum().backward()
        out["warp"] = (y.detach(), s_.grad, f_.grad)
    return out


def option_slab_pieces(mesh, n_spatial, job, n_data=None):
    """The training options' slab forms alone, each on this rank's share
    (its data rank's items, its spatial rank's slab) of ``job``'s global
    tensors (``make_mesh`` of the first ``n_data`` * ``n_spatial`` ranks; a
    rank past the mesh reports ``{"in_mesh": False}``), for the tests to
    hold against the whole-tensor ops:

    - ``convT_<name>`` for each ``job["convT"][name]`` = (a transposed
      conv, its global input, w): ``conv_transpose_slab`` on the input's
      slab, with the input's and the parameters' gradients under
      ``sum(out * w)``;
    - ``dropout``: ``Dropout`` on the slab of ``job["x_drop"]``, its masks
      from a CPU generator seeded ``job["dropout_seed"]``;
    - ``netD_<name>`` for each ``job["netD"][name]`` = (a discriminator,
      its global input): ``discriminate`` and ``gan_loss`` (the G phase's
      real target) on the slab, the loss, the slab's gradient and netD's
      gradients averaged over the mesh's ranks (``all_reduce_grads``);
    - ``keys``: ``all_gather_data`` of the data rank's items of
      ``job["keys"]`` (B, P, C), and ``patch_nce_loss`` with all
      negatives of its queries ``job["queries"]`` against them;
    - ``bf16``: the slab of ``job["x_bf16"]`` (bfloat16) with a halo of
      (1, 1), gathered (``gather_slabs``), and summed over the spatial
      ranks (``spatial_sum``), without gradients;
    - ``unet_bf16`` where ``job["unet_bf16"]`` = (a bfloat16 ``VxmUnet``,
      its global input, w): the UNet on the slab (its levels that do not
      split gathered, in bfloat16), and the input's gradient under
      ``sum(out * w)``."""
    from dfmir_tpu_torch.losses.gan import gan_loss
    from dfmir_tpu_torch.nets.discriminators import discriminate
    from dfmir_tpu_torch.nets.layers import conv_transpose_slab
    mesh = dp.make_mesh(mesh, n_data, n_spatial)
    if mesh is None:
        return {"in_mesh": False}

    def items(t):
        return dp.batch_slice(t, mesh.data_rank, mesh.n_data)

    def share(t):
        return dp.slab_slice(items(t), mesh.spatial_rank,
                             mesh.n_spatial).clone()

    out = {"data_rank": mesh.data_rank, "spatial_rank": mesh.spatial_rank}
    for name, (conv, x, w) in job.get("convT", {}).items():
        conv.zero_grad(set_to_none=True)
        v = share(x).requires_grad_(True)
        y = conv_transpose_slab(conv, v, mesh)
        (y * share(w)).sum().backward()
        out[f"convT_{name}"] = (y.detach(), v.grad, {
            k: p.grad.clone() for k, p in conv.named_parameters()})
    if "x_drop" in job:
        gen = torch.Generator().manual_seed(job["dropout_seed"])
        out["dropout"] = Dropout()(share(job["x_drop"]), gen, mesh)
    for name, (netD, x) in job.get("netD", {}).items():
        netD.zero_grad(set_to_none=True)
        v = share(x).requires_grad_(True)
        pred, split = discriminate(netD, v, mesh)
        loss = gan_loss(pred, True, mesh=split)
        loss.backward()
        dp.all_reduce_grads(netD.parameters(), mesh)
        out[f"netD_{name}"] = (loss.detach(), v.grad, {
            k: p.grad.clone() for k, p in netD.named_parameters()})
    if "keys" in job:
        keys = items(job["keys"])
        q = items(job["queries"])
        out["keys"] = (dp.all_gather_data(keys, mesh), patch_nce_loss(
            q.reshape(-1, q.shape[-1]), keys.reshape(-1, keys.shape[-1]),
            batch_size=q.shape[0], all_negatives_from_minibatch=True,
            mesh=mesh))
    if "x_bf16" in job:
        x = share(job["x_bf16"])
        out["bf16"] = (dp.halo_exchange(x, 1, 1, mesh),
                       dp.gather_slabs(x, mesh), dp.spatial_sum(x, mesh))
    if "unet_bf16" in job:
        unet, x, w = job["unet_bf16"]
        unet.zero_grad(set_to_none=True)
        v = share(x).requires_grad_(True)
        y = unet(v, mesh)
        (y * share(w)).sum().backward()
        out["unet_bf16"] = (y.detach(), v.grad)
    return out


def zoo_slab_pieces(mesh, n_spatial, job, n_data=None):
    """The 2-D-only generators' slab forms alone (``nets/stylegan2.py``,
    ``nets/munit.py``), each on this rank's share of ``job``'s global
    tensors (``make_mesh`` of the first ``n_data`` * ``n_spatial`` ranks;
    a rank past the mesh reports ``{"in_mesh": False}``), for the tests to
    hold against the whole-tensor ops; each value with its input's
    gradient under ``sum(out * w)``, w this rank's slab of a global w:

    - ``fir_<name>`` for each ``job["fir"][name]`` = (kernel, up, down,
      pad, x, w): ``upfirdn2d`` with the mesh;
    - ``module_<name>`` for each ``job["modules"][name]`` = (a module
      taking ``mesh=``, x, w): its output, the input's gradient and the
      parameters' (this rank's part: the ranks' add up to the whole
      image's);
    - ``netG_<name>`` for each ``job["netGs"][name]`` = (a generator, x,
      layers, w): its output and taps on the slab, and the input's
      gradient under ``sum(out * w)``."""
    from dfmir_tpu_torch.nets.stylegan2 import upfirdn2d
    mesh = dp.make_mesh(mesh, n_data, n_spatial)
    if mesh is None:
        return {"in_mesh": False}

    def share(t):
        return dp.slab_slice(dp.batch_slice(t, mesh.data_rank, mesh.n_data),
                             mesh.spatial_rank, mesh.n_spatial).clone()

    out = {"data_rank": mesh.data_rank, "spatial_rank": mesh.spatial_rank}
    for name, (kernel, up, down, pad, x, w) in job.get("fir", {}).items():
        v = share(x).requires_grad_(True)
        y = upfirdn2d(v, kernel, up, down, pad, mesh)
        (y * share(w)).sum().backward()
        out[f"fir_{name}"] = (y.detach(), v.grad)
    for name, (module, x, w) in job.get("modules", {}).items():
        module.zero_grad(set_to_none=True)
        v = share(x).requires_grad_(True)
        y = module(v, mesh=mesh)
        (y * share(w)).sum().backward()
        out[f"module_{name}"] = (y.detach(), v.grad, {
            k: p.grad.clone() for k, p in module.named_parameters()
            if p.grad is not None})
    for name, (netG, x, layers, w) in job.get("netGs", {}).items():
        v = share(x).requires_grad_(True)
        y, feats = netG(v, layers=tuple(layers), mesh=mesh)
        (y * share(w)).sum().backward()
        out[f"netG_{name}"] = (y.detach(), [f.detach() for f in feats],
                               v.grad)
    return out


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


def one_process(mesh, fn, job):
    """``CASES[fn]`` as one process (``mesh=None``) on this rank's device:
    the one-process reference, run by a launch of one rank apart from the
    caller's process, which it leaves holding none of its card memory."""
    return CASES[fn](None, dict(job, device=str(mesh.device)))


def tf32_flags(mesh):
    """The rank's TF32 flags (cuDNN, cuBLAS), as the launch left them."""
    return {"cudnn": torch.backends.cudnn.allow_tf32,
            "matmul": torch.backends.cuda.matmul.allow_tf32}


CASES = {f.__name__: f for f in (registration_steps, vxm_steps,
                                 vxm_spatial_steps, spatial_pieces,
                                 joint_spatial_steps, joint_slab_pieces,
                                 option_slab_pieces, zoo_slab_pieces,
                                 reduce_is_exact,
                                 collectives, nce, loader, one_process,
                                 tf32_flags)}


def run_cases(mesh, cases):
    """{name: CASES[fn](mesh, **kwargs)} for each (name, fn, kwargs)."""
    return {name: CASES[fn](mesh, **kwargs) for name, fn, kwargs in cases}
