"""Checkpoints in the reference's file layout (the JAX package's
``engine/checkpoints.py``): one file a network, ``{epoch}_net_{Name}.pth``
under ``{checkpoints_dir}/{name}``, the ``latest`` tag, and
``{epoch}_optim.pth`` with the optimizer's state, so that a resumed run
continues Adam's moments.

The files are ``torch.save`` of state_dicts under the reference's keys,
tensors on the CPU, and of plain containers: ``torch.load(...,
weights_only=True)`` reads them, and so does the JAX package's own
reference-``.pth`` path.  Where no ``.pth`` exists, ``load_networks`` and
``load_optim`` read the JAX package's ``{epoch}_net_{Name}.msgpack`` /
``{epoch}_optim.msgpack`` through a converter the caller gives
(``compat/convert.py``; needs the ``msgpack`` package).

``save_with_config`` / ``load_with_config`` write and read one file that
carries the config (``RegistrationConfig`` or ``VxmConfig``, as a plain
dict and its class name) beside the state_dicts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from dfmir_tpu_torch.compat.convert import read_flax_msgpack


def _path(save_dir: str, epoch, stem: str, ext: str) -> str:
    return os.path.join(save_dir, f"{epoch}_{stem}{ext}")


def _to_cpu(obj):
    """``obj`` with every tensor in it detached and on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_networks(save_dir: str, epoch,
                  nets: Mapping[str, Mapping[str, torch.Tensor]],
                  opt_extras: Optional[Mapping[str, Any]] = None) -> None:
    """nets: {'G': state_dict, ...}; opt_extras: the optimizer's
    state_dict, the step and what else a resume needs."""
    os.makedirs(save_dir, exist_ok=True)
    for name, sd in nets.items():
        torch.save(_to_cpu(sd),
                   _path(save_dir, epoch, f"net_{name}", ".pth"))
    if opt_extras is not None:
        torch.save(_to_cpu(opt_extras),
                   _path(save_dir, epoch, "optim", ".pth"))


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_networks(save_dir: str, epoch, names: Sequence[str],
                  msgpack_converter: Optional[Callable] = None,
                  verbose: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """State dicts of ``names``: ``{epoch}_net_{name}.pth``, else the JAX
    package's ``.msgpack`` converted by ``msgpack_converter(name, tree)``."""
    out = {}
    for name in names:
        pth = _path(save_dir, epoch, f"net_{name}", ".pth")
        mp = _path(save_dir, epoch, f"net_{name}", ".msgpack")
        if os.path.exists(pth):
            if verbose:
                print(f"loading the model from {pth}")
            out[name] = _load(pth)
        elif os.path.exists(mp) and msgpack_converter is not None:
            if verbose:
                print(f"converting the JAX checkpoint {mp}")
            out[name] = msgpack_converter(name, read_flax_msgpack(mp))
        else:
            raise FileNotFoundError(
                f"no checkpoint for net {name} at {pth} or {mp}")
    return out


def load_optim(save_dir: str, epoch,
               msgpack_converter: Optional[Callable] = None
               ) -> Optional[Dict[str, Any]]:
    """``{epoch}_optim.pth``, else the JAX package's ``.msgpack`` converted
    by ``msgpack_converter(tree)``; None when neither exists."""
    pth = _path(save_dir, epoch, "optim", ".pth")
    mp = _path(save_dir, epoch, "optim", ".msgpack")
    if os.path.exists(pth):
        return _load(pth)
    if os.path.exists(mp) and msgpack_converter is not None:
        return msgpack_converter(read_flax_msgpack(mp))
    return None


# ------------------------------------------------------------ config-carrying

def save_with_config(path: str, cfg,
                     params: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """One file carrying the constructor config beside the state_dicts,
    so that a model reloads without its architecture flags."""
    cfg_dict = {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(cfg).items()}
    blob = {"config": cfg_dict, "config_class": type(cfg).__name__,
            "params": _to_cpu(params)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(blob, path)


def load_with_config(path: str):
    """Returns (cfg, params): cfg rebuilt from the stored class name
    (RegistrationConfig / VxmConfig), params the state_dicts."""
    blob = _load(path)
    name = blob["config_class"]
    if name == "RegistrationConfig":
        from dfmir_tpu_torch.engine.config import RegistrationConfig as C
    elif name == "VxmConfig":
        from dfmir_tpu_torch.engine.vxm_engine import VxmConfig as C
    else:
        raise KeyError(f"unknown config class {name!r}")
    raw = dict(blob["config"])
    for f in dataclasses.fields(C):
        if isinstance(raw.get(f.name), list):
            raw[f.name] = tuple(raw[f.name])
    return C(**raw), blob["params"]
