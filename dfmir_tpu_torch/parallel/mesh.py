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
  ``all_reduce_max``, ``all_gather`` (of a detached tensor; on slabs
  ``all_gather_data``) and ``global_mean`` (a statistic of the global
  batch with this rank's gradient).

**The spatial axis** (JAX's ``make_mesh(n_data, n_spatial)`` with
``shard_batch(..., shard_spatial=True)``, which shards the leading spatial
dim of (B, D, H, W, C)).  ``make_mesh(mesh, n_data, n_spatial)`` takes the
launch's first n_data * n_spatial ranks, as JAX's takes the first devices,
and arranges them as JAX's ``reshape(n_data, n_spatial)`` does: rank =
data_rank * n_spatial + spatial_rank.  Each rank takes its data rank's
items (``batch_slice``) and, of those, its spatial rank's slab of D /
n_spatial planes along D (``slab_slice``), in spatial-rank order.  Where
XLA inserts the exchanges itself, the port's modules call them:

- ``halo_exchange(x, lo, hi, mesh)``: the slab with ``lo`` planes of the
  spatial rank below and ``hi`` of the one above, zeros past the global
  ends (a convolution's zero padding there); its backward sends each
  halo's gradient back to the rank that owns the planes, which adds it;
- ``gather_slabs(x, mesh)``: the whole volume on every spatial rank (an
  all-gather along D); its backward sums the ranks' gradients and gives
  each its slab (a reduce-scatter).  ``all_gather_slabs`` and
  ``reduce_scatter_slabs`` are its two halves without autograd (B5 and B2
  on a slab reduce-scatter int64 sums, ``ops/warp_cuda.py``);
- ``spatial_sum(x, mesh)``: the sum of the spatial ranks' ``x`` on every
  one of them (an all-reduce), whose backward is the same all-reduce of
  the ranks' gradients: the statistics of a norm over the whole volume
  (``nets/layers.py::instance_norm``), and ``gather_rows``, the rows of a
  tensor that each spatial rank owns in part (the rest zeros) put
  together on every one of them (PatchNCE's samples of a tap split over
  the slabs, ``nets/patch_sample.py``).

Which extents split, and where netR stops splitting: an extent of the
image along the split axis is taken where JAX's ``shard_batch`` takes it
(n_spatial divides it) and the whole-image model does, as far as netG's
levels and the half-resolution SVF split too (``check_joint_slabs``, netG
left out for the 3-D ``VxmEngine``); netR's UNet levels that n_spatial
does not divide run on the gathered map, whole on every spatial rank
(``first_whole_level``, ``nets/vxm.py``).

The collectives run over the spatial group (the n_spatial ranks of one
data rank), and ``all_gather_data`` over the data group (the n_data ranks
of one spatial rank: the all-negatives keys, which every spatial rank of
a data rank holds whole), both made on every rank in the same order.  A
16-bit float (bfloat16 netG and netR) crosses as its bytes, so a halo or
a gathered slab arrives bit for bit; a sum of 16-bit floats adds in
float32 and rounds once.  A halo's sends and receives go out as one
``batch_isend_irecv``: under NCCL
(ranks on distinct cards) a rank's receives posted one by one ahead of its
sends would wait on sends queued behind them.  With ``n_spatial=1`` and
every rank of the launch ``make_mesh`` returns the mesh it was given: every
path is the batch axis's data parallelism alone, bit for bit.  A mesh of
fewer ranks than the launch runs its collectives over a group of its own
(``Mesh.group``).  ``BYTES_SENT`` counts the bytes this rank sends in the
exchanges.

**Gloo and the card.** Ranks that share one card run over ``gloo``
(``launch.backend_for``).  On an NVIDIA H100 with torch 2.11, over 2
ranks on one card, gloo took CUDA tensors in ``all_reduce``,
``broadcast``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter`` and ``reduce_scatter_tensor``, with the right values.
Its point-to-point calls did not: ``isend`` / ``irecv`` raised ("writev:
Bad address", the card's pointer taken for host memory), and a blocking
``send`` aborted its process.  So the halos' point-to-point messages go
through host buffers under gloo when the tensors lie on a card
(``_p2p``), as ``_staged`` moves host tensors to the card for NCCL, and
``gather_slabs`` all-gathers and reduce-scatters the card's tensors
directly.

**The gradient scale on slabs.** Every loss keeps ``global_mean``'s
convention over all ``world`` ranks: its value is the global one, and
each rank's gradient is ``world`` times its true share (the terms its
own slab and items contribute, through the exchanges' backwards).  The
mean over all ranks (``all_reduce_grads``) is then the gradient of the
whole step.  A statistic whose ranks hold unequal counts (the gradient
loss: the last slab has one D difference fewer) divides its local sum by
``N / world``, N the global count, before ``global_mean``.  A tensor that
every spatial rank holds whole (a gathered volume, a norm's statistics,
the gathered patch samples and all that is computed from them) carries on
each rank that rank's consumers' part of the cotangent, ``world`` times
their share; the backward of the collective that made it sums those parts
over the spatial ranks (``gather_slabs``' reduce-scatter, ``spatial_sum``'s
all-reduce), which is ``world`` times the whole cotangent, and hands each
rank its own planes' or rows' part of that.  A loss computed alike on
every spatial rank from such a tensor (PatchNCE on the gathered samples)
is then the data rank's value, with ``world`` times its share of the
gradient, as the convention asks.

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

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank of the default process group, and its device; from
    ``make_mesh`` also its place on the (data, spatial) grid, the group of
    the mesh's ranks (where the launch has more) and the spatial group
    through it.  The mesh's ranks are the launch's first ``world``: a
    rank's number is the same in both."""
    rank: int
    world: int
    device: torch.device
    backend: str
    n_spatial: int = 1
    group: Any = None            # the mesh's ranks, where fewer than the
                                 # launch's (None: the default group)
    spatial_group: Any = None    # the n_spatial ranks of this data rank
    data_group: Any = None       # the n_data ranks of this spatial rank
                                 # (None: n_data or n_spatial is 1)

    @property
    def n_data(self) -> int:
        return self.world // self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial


def make_mesh(mesh: Mesh, n_data: Optional[int] = None,
              n_spatial: int = 1) -> Optional[Mesh]:
    """JAX's ``make_mesh(n_data, n_spatial)`` over the first n_data *
    n_spatial ranks of ``mesh`` (the launch's default group), as JAX's
    takes the first devices: rank = data_rank * n_spatial + spatial_rank.
    Every rank of the launch calls it, and every rank makes every group in
    the same order (``dist.new_group``'s rule); a rank past the mesh gets
    None.  ``n_spatial=1`` over every rank returns ``mesh`` itself."""
    if n_data is None:
        n_data = mesh.world // n_spatial
    size = n_data * n_spatial
    if n_data < 1 or n_spatial < 1 or size > mesh.world:
        raise ValueError(f"a mesh of {n_data} x {n_spatial} ranks does not "
                         f"fit the {mesh.world} ranks of the launch")
    if size == mesh.world and n_spatial == 1:
        return mesh
    group = dist.new_group(list(range(size))) if size < mesh.world else None
    spatial = [dist.new_group([d * n_spatial + s for s in range(n_spatial)])
               for d in range(n_data)] if n_spatial > 1 else [None] * n_data
    data = [dist.new_group([d * n_spatial + s for d in range(n_data)])
            for s in range(n_spatial)] if n_spatial > 1 and n_data > 1 else [
                None] * n_spatial
    if mesh.rank >= size:
        return None
    return dataclasses.replace(mesh, world=size, n_spatial=n_spatial,
                               group=group,
                               spatial_group=spatial[mesh.rank // n_spatial],
                               data_group=data[mesh.rank % n_spatial])


def is_spatial(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits the volumes along D (their tensors are
    slabs)."""
    return mesh is not None and mesh.n_spatial > 1


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


def slab_slice(x, spatial_rank: int, n_spatial: int, axis: int = 2):
    """Spatial rank ``spatial_rank``'s slab of ``x`` along ``axis`` (D of
    (B, C, D, H, W)): planes ``[r*D/n, (r+1)*D/n)``.  Raises unless
    ``n_spatial`` divides D."""
    n = x.shape[axis]
    if n % n_spatial:
        raise ValueError(f"{n} planes along axis {axis} do not divide "
                         f"into {n_spatial} slabs")
    k = n // n_spatial
    return x.narrow(axis, spatial_rank * k, k)


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
        dist.all_reduce(flat, group=mesh.group)
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
        dist.all_reduce(flat, group=mesh.group)
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
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts).to(x.device)


def all_gather_data(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """``all_gather`` over the data ranks alone: on slabs the ranks that
    share this spatial rank (``Mesh.data_group``), one a data rank, in
    data-rank order, where every spatial rank of a data rank holds the same
    ``x`` (the gathered patch samples' keys); over every rank without a
    spatial axis."""
    if not is_spatial(mesh):
        return all_gather(x, mesh)
    x = x.detach().contiguous()
    if mesh.n_data == 1:
        return x
    local = _staged(mesh, x)
    parts = [torch.empty_like(local) for _ in range(mesh.n_data)]
    dist.all_gather(parts, local, group=mesh.data_group)
    return torch.cat(parts).to(x.device)


def global_mean(x: torch.Tensor, mesh: Mesh = None) -> torch.Tensor:
    """The mean of ``x`` over the ranks, with the gradient of this rank's
    own ``x``: once the ranks' gradients are averaged
    (``all_reduce_grads``), any function of it has the gradient it has in
    one process over the global batch."""
    if mesh is None:
        return x
    total = x.detach().clone()
    dist.all_reduce(total, group=mesh.group)
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
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out.to(x.device)


def barrier(mesh: Mesh = None) -> None:
    if mesh is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(mesh.group)


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
    dist.all_gather(parts, sums, group=mesh.group)
    bad = [r for r, p in enumerate(parts) if not torch.equal(p, parts[0])]
    if bad:
        raise RuntimeError(f"ranks {bad} hold other parameters or Adam "
                           f"state than rank 0")
    _flat_collective(tensors, mesh,
                     lambda flat: dist.broadcast(flat, 0, group=mesh.group))


# ------------------------------------------------- the spatial exchanges

# the payload bytes this rank sent in the spatial exchanges, by kind: a
# halo's planes to each neighbour; its slab to each other spatial rank in
# an all-gather, and their parts of the gradient in its reduce-scatter
BYTES_SENT = {"halo": 0, "gather": 0, "reduce": 0}
# host seconds this rank spent in them, by kind (a call on the card's
# tensors first waits for the card to reach it); "reduce": the
# all-reduces over the spatial group (``spatial_sum``, ``spatial_max``),
# counted as the bytes of the tensor each rank puts in
EXCHANGE_S = {"halo": 0.0, "gather": 0.0, "reduce": 0.0}


def reset_exchange_counts() -> None:
    for kind in BYTES_SENT:
        BYTES_SENT[kind] = 0
        EXCHANGE_S[kind] = 0.0


@contextlib.contextmanager
def _clock(kind: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        EXCHANGE_S[kind] += time.perf_counter() - t0


def _bits(t: torch.Tensor) -> torch.Tensor:
    """What goes on the wire for ``t`` (contiguous): a 16-bit float as its
    bytes (a uint8 view; gloo refuses int16), so that a halo or a gathered
    slab of bfloat16 arrives bit for bit whatever float dtypes the backend
    takes; other dtypes as they are."""
    return t.view(torch.uint8) if t.element_size() == 2 and (
        t.is_floating_point()) else t


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A sum's operand: a 16-bit float widened to float32, so that the ranks'
    parts add in float32 and the sum rounds once, back in ``t``'s dtype."""
    return t.float() if t.element_size() == 2 and t.is_floating_point() else t


def _spatial_peer(mesh: Mesh, step: int) -> Optional[int]:
    """The global rank ``step`` spatial ranks away from this one, or None
    past either end of the volume."""
    s = mesh.spatial_rank + step
    if 0 <= s < mesh.n_spatial:
        return mesh.data_rank * mesh.n_spatial + s
    return None


def _p2p(mesh: Mesh, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Send ``to_prev`` to the spatial rank below and ``to_next`` to the one
    above; return (from_prev, from_next): the rank below's ``to_next`` and
    the one above's ``to_prev`` (zeros past an end).  The receives and
    sends go out as one batch (``batch_isend_irecv``), each direction with
    its own tag.  Under gloo a card's tensors go through host buffers."""
    prev, nxt = _spatial_peer(mesh, -1), _spatial_peer(mesh, 1)
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    host = mesh.backend == "gloo" and to_prev.is_cuda

    def wire(t):
        return _bits((t.detach().cpu() if host else t.detach()).contiguous())
    with _clock("halo"):
        ops, got = [], []
        for t, peer, tag in ((from_prev, prev, 1), (from_next, nxt, 2)):
            if peer is not None and t.numel():
                buf = wire(t)
                ops.append(dist.P2POp(dist.irecv, buf, peer,
                                      mesh.spatial_group, tag))
                got.append((t, buf))
        for t, peer, tag in ((to_prev, prev, 2), (to_next, nxt, 1)):
            if peer is not None and t.numel():
                buf = wire(t)
                ops.append(dist.P2POp(dist.isend, buf, peer,
                                      mesh.spatial_group, tag))
                BYTES_SENT["halo"] += buf.numel() * buf.element_size()
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        for t, buf in got:
            t.copy_(buf.view(t.dtype))
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, mesh):
        D = x.shape[2]
        if lo > D or hi > D:
            raise ValueError(f"a halo of ({lo}, {hi}) planes reaches past "
                             f"the neighbours' slabs of {D}")
        ctx.lo, ctx.hi, ctx.mesh = lo, hi, mesh
        below, above = _p2p(mesh, x.narrow(2, 0, hi), x.narrow(2, D - lo, lo))
        return torch.cat([below, x, above], dim=2)

    @staticmethod
    def backward(ctx, g):
        lo, hi, mesh = ctx.lo, ctx.hi, ctx.mesh
        D = g.shape[2] - lo - hi
        g_below, g_mid, g_above = g.split([lo, D, hi], dim=2)
        # the halos' gradients go back to their owners: g_below is the rank
        # below's last lo planes', g_above the rank above's first hi planes'
        from_prev, from_next = _p2p(mesh, g_below, g_above)
        dx = g_mid.clone()
        if hi:
            dx[:, :, :hi] += from_prev
        if lo:
            dx[:, :, D - lo:] += from_next
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, lo: int, hi: int,
                  mesh: Mesh) -> torch.Tensor:
    """This rank's slab ``x`` (B, C, D, ...) with ``lo`` planes of the
    spatial rank below before it and ``hi`` planes of the rank above after
    it: (B, C, lo + D + hi, ...), zeros past the volume's ends.  Every
    spatial rank calls it with the same ``lo`` and ``hi``."""
    return _Halo.apply(x, lo, hi, mesh)


def all_gather_slabs(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The spatial ranks' slabs ``x`` concatenated along D in spatial-rank
    order, without a gradient."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_spatial)]
    with _clock("gather"):
        dist.all_gather([_bits(p) for p in parts], _bits(x),
                        group=mesh.spatial_group)
    BYTES_SENT["gather"] += ((mesh.n_spatial - 1) * x.numel()
                             * x.element_size())
    return torch.cat(parts, dim=2)


def reduce_scatter_slabs(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slab (its 1 / n_spatial of axis 2: D planes at 3-D, H
    rows at 2-D) of the sum over the spatial ranks of their whole-image
    ``x``, without a gradient; in ``x``'s dtype (int64 sums add
    exactly; a bfloat16 one adds in float32, ``_wide``)."""
    parts = [_wide(p).contiguous()
             for p in x.detach().chunk(mesh.n_spatial, dim=2)]
    out = torch.empty_like(parts[0])
    with _clock("gather"):
        dist.reduce_scatter(out, parts, group=mesh.spatial_group)
    BYTES_SENT["gather"] += sum(p.numel() * p.element_size()
                                for i, p in enumerate(parts)
                                if i != mesh.spatial_rank)
    return out.to(x.dtype)


class _GatherSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_slabs(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_slabs(g, ctx.mesh), None


def gather_slabs(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The spatial ranks' slabs ``x`` concatenated along D in spatial-rank
    order: the whole volume, on every spatial rank.  The gradient of a
    rank's slab is the sum of every rank's gradient of its planes.  ``x``
    itself where ``mesh`` does not split the volume."""
    if not is_spatial(mesh):
        return x
    return _GatherSlabs.apply(x, mesh)


# ------------------------------------------- the joint model on slabs

def _spatial_all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    """``x`` reduced by ``op`` over the spatial group, in a new tensor on
    ``x``'s device and dtype (detached; a bfloat16 ``x`` reduced in
    float32, ``_wide``)."""
    out = _staged(mesh, _wide(x.detach()).clone().contiguous())
    with _clock("reduce"):
        dist.all_reduce(out, op=op, group=mesh.spatial_group)
    BYTES_SENT["reduce"] += out.numel() * out.element_size()
    return out.to(x.device, x.dtype)


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _spatial_all_reduce(x, mesh, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _spatial_all_reduce(g, ctx.mesh, dist.ReduceOp.SUM), None


def spatial_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of the spatial ranks' ``x`` (each rank's part of a
    statistic of the whole volume), on every spatial rank; its backward
    sums the ranks' gradients the same way (the module's convention).
    ``x`` itself where ``mesh`` does not split the volume."""
    if not is_spatial(mesh):
        return x
    return _SpatialSum.apply(x, mesh)


def spatial_max(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise max of the spatial ranks' ``x``, detached (the bits
    of max|g| that B5's and, a batch item each, B2's slab forms share);
    ``x`` where ``mesh`` does not split the volume."""
    if not is_spatial(mesh):
        return x
    return _spatial_all_reduce(x, mesh, dist.ReduceOp.MAX)


def gather_rows(x: torch.Tensor, owned: torch.Tensor,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """Rows put together from the spatial ranks that own them: ``x`` (B, P,
    C) holds, at the P positions where ``owned`` (P,) is true, rows of this
    rank's slab (PatchNCE's samples at ids that fall in its planes), and
    every position is owned by exactly one spatial rank.  Returns, on every
    spatial rank, each position's row from its owner, in position order
    (the ids' order); a sum with zeros, so exact.  The gradient of a row
    goes to its owner, summed over the ranks (``spatial_sum``)."""
    if not is_spatial(mesh):
        return x
    return spatial_sum(torch.where(owned[None, :, None], x,
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device)), mesh)


def slab_rows(rows: int, pad: int, mesh: Mesh):
    """(offset, total): where this rank's ``rows`` rows lie along the split
    axis of a map whose slabs carry ``pad`` extra rows at each global end
    (a reflect pad's output, e.g. netG's tap 0: the two end ranks own its
    pad's rows), and the map's whole extent."""
    r, n = mesh.spatial_rank, mesh.n_spatial
    core = rows - pad if r in (0, n - 1) else rows
    return (0 if r == 0 else pad + r * core), n * core + 2 * pad


def first_whole_level(extent: int, n_spatial: int,
                      depth: int) -> Optional[int]:
    """The first level of netR's UNet, ``depth`` strided levels deep, that
    does not split over ``n_spatial`` spatial ranks: level l holds
    ``extent / 2^l`` rows (l = 0 the input, l = depth the coarsest), and it
    splits when ``n_spatial`` divides them, every slab then holding at least
    one row, the deepest halo a conv of netR takes (a stride-1 3x3 conv: 1
    row each side; a stride-2 one: 1 below).  That level and every coarser
    one run on the gathered map, whole on every spatial rank; None when
    every level splits.  ``extent`` must be divisible by 2^depth."""
    for level in range(depth + 1):
        if (extent >> level) % n_spatial:
            return level
    return None


def _refuse_extent(extent: int, n_spatial: int, unit: int,
                   what: str) -> None:
    """JAX's rule (``shard_batch``: n_spatial divides the extent) and the
    whole-image model's (``unit``, the lcm of ``what`` its levels divide
    by)."""
    if extent % n_spatial:
        raise ValueError(
            f"an extent of {extent} does not split over {n_spatial} spatial "
            f"ranks: n_spatial must divide it (JAX's shard_batch)")
    if extent % unit:
        raise ValueError(
            f"an extent of {extent} does not go through the whole-image "
            f"model: it must be divisible by {unit} = lcm({what})")


def _refuse_svf(extent: int, n_spatial: int, int_downsize: int) -> None:
    """The half-resolution SVF's resize runs on slabs: n_spatial must
    divide its rows."""
    if (extent // int_downsize) % n_spatial:
        raise ValueError(
            f"an extent of {extent} does not split over {n_spatial} spatial "
            f"ranks at the SVF's int_downsize {int_downsize}: "
            f"{extent // int_downsize} rows (n_spatial * int_downsize must "
            f"divide the extent)")


def check_joint_slabs(extent: int, n_spatial: int, n_enc: int,
                      int_downsize: int,
                      level_pads: Sequence[int] = ()) -> Optional[int]:
    """Raise unless the joint model takes an image of ``extent`` rows (H
    at 2-D, D planes at 3-D) split into ``n_spatial`` slabs; return netR's
    first level that runs gathered (``first_whole_level``).  The rule:

    - ``n_spatial`` divides ``extent`` (JAX's ``shard_batch``), and the
      whole-image model takes it: ``extent`` divisible by lcm(2^n_enc,
      int_downsize, 2^levels), netR's ``n_enc`` strided levels and netG's
      ``levels = len(level_pads) - 1`` downsamplings (no ``level_pads``:
      netR alone, the 3-D ``VxmEngine``);
    - netG's levels split: each slab holds ``extent / (n_spatial * 2^l)``
      rows at netG's level l, more than ``level_pads[l]``, the largest
      reflect or replicate pad there (a pad at a global end reads the
      slab's own rows 1..p) or, for the zero-padded StyleGAN2 generators,
      the largest halo (a halo of h rows reads h rows of a neighbour's
      slab: the same rule asks one row more than that needs, so zero
      pads add no rule of their own);
    - the half-resolution SVF splits (``_refuse_svf``);
    - netR's levels need nothing more: those that do not split run on the
      gathered map."""
    levels = max(len(level_pads) - 1, 0)
    _refuse_extent(extent, n_spatial,
                   math.lcm(2 ** n_enc, int_downsize, 2 ** levels),
                   f"2^len(vxm_enc) {2 ** n_enc}, int_downsize "
                   f"{int_downsize}" + (f", netG's 2^{levels}"
                                        if level_pads else ""))
    for level, pad in enumerate(level_pads):
        rows = extent / (n_spatial * 2 ** level)
        if rows != int(rows) or rows <= pad:
            raise ValueError(
                f"slabs of {rows:g} rows at netG's level {level} (extent "
                f"{extent} over {n_spatial} spatial ranks) do not hold a "
                f"whole number of rows more than its pad of {pad}")
    _refuse_svf(extent, n_spatial, int_downsize)
    return first_whole_level(extent, n_spatial, n_enc)
