"""Data parallelism over processes: the port's counterpart of the JAX
package's ``parallel/mesh.py``.

The JAX package trains SPMD over a ``jax.sharding.Mesh``: the batch is
sharded over a ``data`` axis, the parameters are replicated, and XLA
all-reduces the gradients.  The port runs one process (a *rank*) per
device, each holding the whole model.  Each rank takes its slice of the
global batch, the gradients are averaged over the ranks between
``backward()`` and Adam, and the losses a step returns are the global
batch's.  The JAX names map so:

- ``make_mesh`` -> ``Mesh``: the process group (``torch.distributed``'s
  default group, which ``parallel.launch`` initialises) and this rank's
  device: rank, world, device, backend;
- ``shard_batch`` -> ``batch_slice``: rank r of n takes items
  ``[r*B/n, (r+1)*B/n)`` of the global batch, as ``shard_batch`` splits
  it along the ``data`` axis;
- ``replicate`` -> ``replicate``: a broadcast of the parameters and
  Adam's state from rank 0, after init and after a checkpoint load, once
  every rank is found to hold rank 0's (one seed, or one checkpoint that
  each rank read);
- ``batch_sharding`` / ``replicated``: no counterpart, a rank's tensors
  live on its own device;
- new: ``all_reduce_grads`` (the mean), ``all_reduce_metrics`` (the mean),
  ``all_reduce_max``, ``all_gather`` (of a detached tensor) and
  ``global_mean`` (a statistic of the global batch with this rank's
  gradient).

JAX's ``spatial`` axis is not ported: JAX's own command line never uses
it (``parallelize`` passes ``n_data`` only), and it needs halo exchanges
around every convolution (ROADMAP A12b).

**Why an explicit all-reduce and not ``DistributedDataParallel``.** JAX's
step keeps the parameters replicated and all-reduces the gradients; so
does this one, with one flat buffer a network: ``all_reduce(SUM)``, then a
division by the world size.  DDP's reducer fits the step badly: netG runs
two or three times before one backward (the taps, FastCUT's re-encode),
netF once for each NCE call, and netD's gradients from the G phase are
thrown away.  DDP would need ``static_graph`` or
``find_unused_parameters`` for that, and would all-reduce netD's discarded
gradients.

**Which losses need the global batch.** The mean over ranks of the
ranks' gradients is the global gradient when each rank's loss is its own
slice's mean: PatchNCE (without all negatives), smoothness, MSE, the
gradient loss and the GAN losses are.  Three are not: the masked L1 is a
ratio of batch sums, NCC is ``-sqrt`` of a batch mean, and PatchNCE with
``nce_includes_all_negatives_from_minibatch`` draws its negatives from
every image of the batch.  The first two reduce their sums with
``global_mean``, the third all-gathers its keys (``losses/``).

Every helper takes ``mesh=None`` (one process) and is then the identity.
With one rank they still run their collectives, and the result is exact:
a sum over one rank, a division by 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank of the default process group, and its device."""
    rank: int
    world: int
    device: torch.device
    backend: str


def check_share(n: int, batch_size: int, mesh: Mesh = None) -> None:
    """Raise unless a batch of ``n`` items is a rank's share of a global
    batch of ``batch_size`` (``batch_size / world`` items).  The sliced
    loader (``data/``) cuts the shares; a task's ``set_input`` takes what
    it is given and checks it here."""
    if mesh is not None and n != batch_size // mesh.world:
        raise ValueError(f"rank {mesh.rank} of {mesh.world} was given "
                         f"{n} items, not its share of a batch of "
                         f"{batch_size}: the loader slices the batch "
                         f"(create_dataset(opt, rank, world))")


def batch_slice(x, rank: int, world: int):
    """Rank ``rank``'s items of the global batch ``x`` (leading axis):
    ``[rank*B/world, (rank+1)*B/world)``.  Raises unless ``world``
    divides B."""
    n = len(x)
    if n % world:
        raise ValueError(f"a batch of {n} does not divide over {world} "
                         f"ranks")
    k = n // world
    return x[rank * k:(rank + 1) * k]


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can reach it: NCCL takes only tensors on
    the rank's card, so a host tensor goes there (the caller copies the
    result back)."""
    if mesh.backend == "nccl" and t.device != mesh.device:
        return t.to(mesh.device)
    return t


def _flat_collective(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     collective) -> None:
    """``collective(buffer)`` on one flat buffer for each (device, dtype)
    group of ``tensors``, written back into them in place."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        flat = _staged(mesh, torch.cat([t.detach().reshape(-1)
                                        for t in group]))
        collective(flat)
        sizes = [t.numel() for t in group]
        with torch.no_grad():
            for t, v in zip(group, flat.split(sizes)):
                t.copy_(v.view_as(t))


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     mesh: Mesh = None) -> None:
    """Average the parameters' ``.grad`` over the ranks, in place, in one
    flat buffer.  Parameters without a gradient are skipped: every rank
    runs the same graph, so they are the same on every rank."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(mesh.world)
    _flat_collective(grads, mesh, mean)


def all_reduce_metrics(metrics: Dict[str, torch.Tensor],
                       mesh: Mesh = None) -> Dict[str, torch.Tensor]:
    """The metrics averaged over the ranks (detached): the global batch's
    where each rank's is its slice's mean."""
    if mesh is None:
        return metrics
    out = {k: v.detach().clone() for k, v in metrics.items()}

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(mesh.world)
    _flat_collective(list(out.values()), mesh, mean)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the leading axis in rank order,
    without a gradient."""
    x = x.detach().contiguous()
    if mesh is None:
        return x
    local = _staged(mesh, x)
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local)
    return torch.cat(parts).to(x.device)


def global_mean(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """The mean of ``x`` over the ranks, with the gradient of this rank's
    own ``x``: once the ranks' gradients are averaged
    (``all_reduce_grads``), any function of it has the gradient it has in
    one process over the global batch."""
    if mesh is None:
        return x
    total = x.detach().clone()
    dist.all_reduce(total)
    return x + (total / mesh.world - x.detach())


def global_sum(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, as ``global_mean``."""
    if mesh is None:
        return x
    return global_mean(x, mesh) * mesh.world


def all_reduce_max(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """The ranks' ``x`` reduced by an elementwise max (detached), in a
    new tensor; a min is ``-all_reduce_max(-x)``."""
    if mesh is None:
        return x
    out = _staged(mesh, x.detach().clone())
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out.to(x.device)


def barrier(mesh: Mesh = None) -> None:
    if mesh is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def state_tensors(modules: Sequence[torch.nn.Module],
                  optimizers: Sequence[torch.optim.Optimizer]
                  ) -> List[torch.Tensor]:
    """The parameters of ``modules`` and every tensor of the optimizers'
    states, in an order that every rank shares."""
    out = [p for m in modules for p in m.parameters()]
    for opt in optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                out += [state[k] for k in sorted(state)
                        if isinstance(state[k], torch.Tensor)]
    return out


def checksum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One int64 a tensor: the sum of its elements' bit patterns (exact,
    in any order), on the first tensor's device."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    dev = tensors[0].device
    return torch.stack([
        t.detach().reshape(-1).view(ints[t.element_size()]).to(
            dev, torch.int64).sum() for t in tensors])


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh = None) -> None:
    """JAX's ``replicate``: rank 0's ``tensors`` on every rank, in place.
    Every rank builds them itself (one seed, or one checkpoint that each
    reads), so first check that they agree (a checksum of each,
    all-gathered) and fail loudly where a rank holds other ones (another
    checkpoint file); then broadcast."""
    if mesh is None or not tensors:
        return
    sums = _staged(mesh, checksum(tensors))
    parts = [torch.empty_like(sums) for _ in range(mesh.world)]
    dist.all_gather(parts, sums)
    bad = [r for r, p in enumerate(parts) if not torch.equal(p, parts[0])]
    if bad:
        raise RuntimeError(f"ranks {bad} hold other parameters or Adam "
                           f"state than rank 0")
    _flat_collective(tensors, mesh, lambda flat: dist.broadcast(flat, 0))
