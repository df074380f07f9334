"""Dataset registry and the batching loader (the JAX package's
``data/loader.py``): shuffle with ``default_rng((seed, epoch))``, drop the
last partial batch in training, ``max_dataset_size``, ``set_epoch``, and a
thread pool that decodes up to 3 batches ahead with ``--num_threads``.
Batches are dicts of stacked NCHW (NCDHW for volumes) arrays and lists of
paths.

Data parallel (``rank``, ``world``): each rank decodes only its slice of
each global batch (``parallel.mesh.batch_slice``), in the order one
process takes; ``len()`` stays the global dataset's."""

from __future__ import annotations

import importlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from dfmir_tpu_torch.parallel.mesh import batch_slice

# dataset modes of the JAX package that the port does not have yet
_NOT_PORTED = {"patient_site": "A13", "triplet": "A13"}


def find_dataset_using_name(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset_mode {name!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[name]})")
    module = importlib.import_module(f"dfmir_tpu_torch.data.{name}")
    target = name.replace("_", "") + "dataset"
    for attr in dir(module):
        if attr.lower() == target and isinstance(getattr(module, attr), type):
            return getattr(module, attr)
    raise ImportError(
        f"dfmir_tpu_torch.data.{name} has no class matching {target!r}")


def get_option_setter(name: str):
    return find_dataset_using_name(name).modify_commandline_options


def create_dataset(opt, rank: int = 0, world: int = 1) -> "DataLoader":
    dataset_cls = find_dataset_using_name(opt.dataset_mode)
    return DataLoader(dataset_cls(opt), opt, rank, world)


def _stack(samples):
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Iterable over dict batches {'A': (B, C, H, W), 'B': ..., paths}:
    rank ``rank`` of ``world``'s slice of each (B / world items)."""

    def __init__(self, dataset, opt, rank: int = 0, world: int = 1):
        if len(dataset) == 0:
            raise RuntimeError(
                f"Found 0 samples under {opt.dataroot} for dataset_mode="
                f"{opt.dataset_mode!r} (phase {opt.phase!r})")
        self.dataset = dataset
        self.opt = opt
        self.batch_size = opt.batch_size
        self.shuffle = not opt.serial_batches
        self.drop_last = bool(getattr(opt, "isTrain", False))
        self.num_threads = max(int(getattr(opt, "num_threads", 0)), 0)
        self.max_dataset_size = getattr(opt, "max_dataset_size", float("inf"))
        self.seed = int(getattr(opt, "seed", 0) or 0)
        self.rank, self.world = rank, world
        if self.batch_size % world:
            raise ValueError(f"--batch_size {self.batch_size} does not "
                             f"divide over {world} ranks")
        self._epoch = 0

    def load_data(self) -> "DataLoader":
        return self

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = min(len(self.dataset), self.max_dataset_size)
        if self.drop_last:
            return int(n // self.batch_size) * self.batch_size
        return int(n)

    def _indices(self):
        n = int(min(len(self.dataset), self.max_dataset_size))
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(idx)
        if self.drop_last:
            idx = idx[: (n // self.batch_size) * self.batch_size]
        return idx

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.world > 1:
            batches = [batch_slice(b, self.rank, self.world)
                       for b in batches]
        if self.num_threads <= 0:
            for b in batches:
                yield _stack([self.dataset[int(i)] for i in b])
            return
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            # pipeline: submit up to 2 batches ahead
            pending = []
            it = iter(batches)

            def submit_next():
                b = next(it, None)
                if b is not None:
                    pending.append([pool.submit(self.dataset.__getitem__,
                                                int(i)) for i in b])
            for _ in range(3):
                submit_next()
            while pending:
                futs = pending.pop(0)
                batch = _stack([f.result() for f in futs])
                submit_next()
                yield batch
