"""Start one rank per device and collect their results.

    results = launch(fn, ["cuda:0", "cuda:1"], args=(job,))

runs ``fn(mesh, *args)`` in one process per device (``mesh`` a
``parallel.mesh.Mesh``) and returns the ranks' return values in rank
order.  ``fn`` and ``args`` are pickled: ``fn`` is a module-level function
that imports without JAX, and a rank returns host data (its result goes
back through a file written with ``torch.save``).

- The processes start with the ``spawn`` method (``torch.multiprocessing``)
  and join the default process group through a ``file://`` store in a
  temporary directory, so that launches running side by side never share
  a port.
- The backend follows from the devices (``backend_for``): ``nccl`` for
  distinct cards, ``gloo`` for CPU ranks and for ranks that share one
  card.  Nothing switches backend or device on a failure.
- ``collective_timeout`` bounds ``init_process_group`` and every
  collective of the ranks: a rank left waiting for another raises.
  ``timeout`` bounds the launch as a whole.  A rank that raises fails the
  launch: the other ranks are stopped, and ``RankFailed`` carries the
  traceback of every rank that raised, the first to raise first (a rank
  whose peer failed raises too, in its collective).  Past ``timeout``
  every rank is stopped and ``TimeoutError`` raised.
- With a CUDA device the kernel library is built in the parent first, so
  that the ranks load it and never run ``nvcc`` each.
"""

from __future__ import annotations

import datetime
import glob
import os
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from dfmir_tpu_torch.device import float32_math
from dfmir_tpu_torch.parallel.mesh import Mesh

CPU_THREADS = 2      # torch's intra-op threads in a CPU rank: ranks share
                     # the host's cores with each other and the parent


class RankFailed(RuntimeError):
    """A rank of a launch raised; the message holds the tracebacks."""


def backend_for(devices: Sequence) -> str:
    """``nccl`` for distinct cards, ``gloo`` otherwise (CPU ranks, or
    ranks that share a card)."""
    devices = [torch.device(d) for d in devices]
    distinct = len({str(d) for d in devices}) == len(devices)
    if all(d.type == "cuda" for d in devices) and distinct:
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, devices, backend, store, args,
               collective_timeout):
    float32_math()
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(CPU_THREADS)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store, 'group')}",
        rank=rank, world_size=len(devices),
        timeout=datetime.timedelta(seconds=collective_timeout),
        **({"device_id": device} if backend == "nccl" else {}))
    try:
        out = fn(Mesh(rank, len(devices), device, backend), *args)
        path = os.path.join(store, f"result_{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        # written before the group goes down, so that the rank which
        # failed first is on record before its peers fail in turn
        with open(os.path.join(store, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence, args=(),
           timeout: Optional[float] = None,
           collective_timeout: float = 600.0):
    """``fn(mesh, *args)`` on one rank per device; their return values in
    rank order."""
    devices = [torch.device(d) for d in devices]
    backend = backend_for(devices)
    if any(d.type == "cuda" for d in devices):
        from dfmir_tpu_torch.ops import _build
        _build.build()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dfmir_ranks_") as store:
        ctx = mp.start_processes(
            _rank_main, args=(fn, devices, backend, store, tuple(args),
                              collective_timeout),
            nprocs=len(devices), join=False, start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{len(devices)} ranks of {fn.__name__} did not end "
                        f"within {timeout} s")
        except ProcessException as err:
            raise RankFailed(_failures(store, fn, len(devices), err)) from err
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(store, f"result_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(len(devices))]


def _failures(store, fn, world, err) -> str:
    """Each failed rank's traceback, in the order they failed (``err``'s
    message where no rank got to write one: one died before ``fn``)."""
    files = sorted(glob.glob(os.path.join(store, "error_*.txt")),
                   key=os.path.getmtime)
    parts = []
    for path in files:
        rank = os.path.basename(path)[len("error_"):-len(".txt")]
        with open(path) as f:
            parts.append(f"rank {rank} of {world}:\n{f.read()}")
    return (f"{fn.__name__} failed on {len(files)} of {world} ranks\n"
            + "\n".join(parts or [str(err)]))
