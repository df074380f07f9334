"""The weight bridge: JAX package parameter trees -> the port's state_dicts,
JAX checkpoints (flax msgpack, optax Adam state) -> the port's, and the
layout helpers the parity tests share.

The input is a JAX param tree as nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, state.params)``.  Layout maps, at 2-D and 3-D
alike: flax conv kernel (*k, in, out) -> torch Conv (out, in, *k); flax
transposed-conv kernel (*k, in, out) -> torch ConvTranspose (in, out,
*k).  Keys are the reference state_dict's: netG ``model.<i>.*``, netR
``unet_model.{downarm,uparm,extras}.<i>.main.*`` and ``flow.*``, netF
``mlp_<i>.{0,2}.*``, netD ``model.<i>.*`` (``net.<i>.*`` for the pixel
discriminator).  A flax Dense kernel (in, out) becomes an nn.Linear
weight (out, in).  Adam's moments take the same maps as their parameters.
The zoo's networks (unet, munit, StyleGAN2, the transformer netR, the
netF heads) and the affine net keep flax's module names, so
``state_from_flax`` maps them by walking the port's modules
(``affine_state_from_jax`` for the affine net).

``read_flax_msgpack`` decodes a checkpoint file that flax's
``msgpack_serialize`` wrote, with the ``msgpack`` package (imported inside
the function: only JAX checkpoints need it) and numpy; no flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dfmir_tpu_torch.nets.discriminators import (NLayerDiscriminator,
                                                 PixelDiscriminator)
from dfmir_tpu_torch.nets.patch_sample import PatchSampleF
from dfmir_tpu_torch.nets.resnet_gen import ResnetGenerator
from dfmir_tpu_torch.nets.vxm import VxmDense


def to_nchw(a) -> np.ndarray:
    """(B, *spatial, C) -> (B, C, *spatial), as a numpy array."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


def to_nhwc(a) -> np.ndarray:
    """(B, C, *spatial) -> (B, *spatial, C); takes numpy or torch."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), 1, -1))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv_w(x) -> torch.Tensor:
    x = np.asarray(x)
    nd = x.ndim - 2
    return _t(np.transpose(x, (nd + 1, nd) + tuple(range(nd))))


def _convT_w(x) -> torch.Tensor:
    x = np.asarray(x)
    nd = x.ndim - 2
    return _t(np.transpose(x, (nd, nd + 1) + tuple(range(nd))))


def _conv(p) -> Dict[str, torch.Tensor]:
    out = {"weight": _conv_w(p["kernel"])}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def netG_state_from_jax(params: Mapping[str, Any], specs, use_dropout=False,
                        padding_type="reflect") -> Dict[str, torch.Tensor]:
    """JAX ResnetGenerator params -> the port's netG state_dict (weights
    only; the blur layers' ``filt`` buffers are the module's own)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, s in enumerate(specs):
        kind = s["kind"]
        if kind == "conv":
            for k, v in _conv(params[f"layer_{i}"]["Conv_0"]).items():
                sd[f"model.{i}.{k}"] = v
        elif kind == "convT":
            p = params[f"layer_{i}"]
            sd[f"model.{i}.weight"] = _convT_w(p["kernel"])
            if "bias" in p:
                sd[f"model.{i}.bias"] = _t(p["bias"])
        elif kind == "resblock":
            if padding_type == "zero":
                convs = (0, 4 if use_dropout else 3)
            else:
                convs = (1, 6 if use_dropout else 5)
            for j, c in enumerate(convs):
                p = params[f"layer_{i}"][f"ConvND_{j}"]["Conv_0"]
                for k, v in _conv(p).items():
                    sd[f"model.{i}.conv_block.{c}.{k}"] = v
    return sd


def netR_state_from_jax(params: Mapping[str, Any], enc_nf,
                        dec_nf) -> Dict[str, torch.Tensor]:
    """JAX VxmDense params -> the port's netR state_dict."""
    unet = params["unet"]
    n_enc = len(enc_nf)
    arms = ([("downarm", f"down_{i}", i) for i in range(n_enc)]
            + [("uparm", f"up_{i}", i) for i in range(n_enc)]
            + [("extras", f"extra_{i}", i) for i in range(len(dec_nf) - n_enc)])
    sd: Dict[str, torch.Tensor] = {}
    for arm, name, i in arms:
        for k, v in _conv(unet[name]["ConvND_0"]["Conv_0"]).items():
            sd[f"unet_model.{arm}.{i}.main.{k}"] = v
    for k, v in _conv(params["flow"]).items():
        sd[f"flow.{k}"] = v
    return sd


def netF_state_from_jax(
        params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX PatchSampleF params (``mlp_<i>_<j>`` Dense layers) -> the port's
    netF state_dict; ``{}`` for the parameterless ``sample`` head."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        i, j = name[len("mlp_"):].split("_")
        prefix = f"mlp_{i}.{2 * int(j)}"
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(p["bias"])
    return sd


def netD_state_from_jax(params: Mapping[str, Any],
                        net) -> Dict[str, torch.Tensor]:
    """JAX discriminator params (``conv_<k>/Conv_0``; under ``nlayer`` for
    the patch discriminator) -> the state_dict of the port's ``net``, whose
    k-th conv in Sequential order is JAX's ``conv_<k>``."""
    if "nlayer" in params:
        params = params["nlayer"]
    seq_name, seq = next(iter(net.named_children()))
    convs = [i for i, m in enumerate(seq)
             if isinstance(m, torch.nn.modules.conv._ConvNd)]
    if len(convs) != len(params):
        raise KeyError(f"{type(net).__name__} has {len(convs)} convs, the "
                       f"JAX tree {len(params)}: {sorted(params)}")
    sd: Dict[str, torch.Tensor] = {}
    for k, i in enumerate(convs):
        for name, v in _conv(params[f"conv_{k}"]["Conv_0"]).items():
            sd[f"{seq_name}.{i}.{name}"] = v
    return sd


def _tree_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _flax_path(tree, segments, leaf):
    """The key path of a port module's subtree in a flax tree: the port's
    names are flax's, but for a wrapper segment (``VxmConvBlock.main``)
    where flax has a single child (``ConvND_0``); then single-child
    wrappers (``Conv_0``) are descended until ``leaf`` is found."""
    node, path = tree, ()
    for seg in segments:
        if seg not in node:
            kids = [k for k, v in node.items() if isinstance(v, Mapping)]
            if len(kids) != 1:
                raise KeyError(f"no {seg!r} at {'/'.join(path) or '/'}: "
                               f"{sorted(node)}")
            seg = kids[0]
        node, path = node[seg], path + (seg,)
    while leaf not in node:
        kids = [k for k, v in node.items() if isinstance(v, Mapping)]
        if len(kids) != 1:
            raise KeyError(f"no {leaf!r} under {'/'.join(path)}: "
                           f"{sorted(node)}")
        node, path = node[kids[0]], path + (kids[0],)
    return node, path


def _module_state(module, node):
    """A module's own parameters from its flax subtree, by type."""
    if hasattr(module, "flax_state"):
        return module.flax_state(node)
    if isinstance(module, torch.nn.modules.conv._ConvTransposeNd):
        out = {"weight": _convT_w(node["kernel"])}
    elif isinstance(module, torch.nn.modules.conv._ConvNd):
        out = {"weight": _conv_w(node["kernel"])}
    elif isinstance(module, torch.nn.Linear):
        k = np.asarray(node["kernel"]).reshape(module.in_features,
                                               module.out_features)
        out = {"weight": _t(k.T)}
    elif isinstance(module, torch.nn.LayerNorm):
        out = {"weight": _t(node["scale"])}
    else:
        return {name: _t(node[name])
                for name, _ in module.named_parameters(recurse=False)}
    if "bias" in node:
        out["bias"] = _t(np.asarray(node["bias"]).reshape(-1))
    return out


def state_from_flax(net, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax param tree (or Adam moments of one) of a zoo network as the
    state_dict of the port's ``net``, whose module names are flax's
    (``nets/{unet_gen,munit,stylegan2,transfusion,feature_nets}.py``).
    Every parameter of ``net`` must be found, with its shape, and every
    leaf of ``tree`` used."""
    sd: Dict[str, torch.Tensor] = {}
    used = set()
    for mpath, module in net.named_modules():
        own = dict(module.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(module, (torch.nn.modules.conv._ConvNd,
                               torch.nn.Linear)):
            leaf = "kernel"
        elif isinstance(module, torch.nn.LayerNorm):
            leaf = "scale"
        else:
            leaf = next(iter(own))
        node, path = _flax_path(tree, mpath.split(".") if mpath else [],
                                leaf)
        for name, v in _module_state(module, node).items():
            key = f"{mpath}.{name}" if mpath else name
            if tuple(v.shape) != tuple(own[name].shape):
                raise ValueError(f"{key}: {tuple(v.shape)} from the JAX tree, "
                                 f"{tuple(own[name].shape)} in the port")
            sd[key] = v
        used.update(path + (k,) for k in node
                    if not isinstance(node[k], Mapping))
    unused = set(_tree_leaves(tree)) - used
    if unused:
        raise KeyError(f"{type(net).__name__}: JAX leaves not in the port: "
                       f"{sorted('/'.join(u) for u in unused)}")
    return sd


def affine_state_from_jax(net, params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``AffineRegistration`` params (``loc/loc_{i}``, ``loc/fc_0``,
    ``loc/fc_theta``) -> the port's ``nets/affine_net.py`` module's
    state_dict; ``fc_0``'s rows are reordered from flax's channels-last
    flatten to the port's (``FlatDense.flax_state``)."""
    return state_from_flax(net, params)


def load_strict(net, sd) -> None:
    """Load ``sd`` into ``net``; every weight (not the blur layers' fixed
    ``filt`` buffers) must be given, and nothing else."""
    full = net.state_dict()
    missing = [k for k in full if k not in sd and not k.endswith(".filt")]
    extra = [k for k in sd if k not in full]
    if missing or extra:
        raise KeyError(f"{type(net).__name__}: missing {missing}, "
                       f"unexpected {extra}")
    full.update(sd)
    net.load_state_dict(full, strict=True)


NETS = {"G": "netG", "F": "netF", "R": "netR"}
# the networks of a RegistrationModel by JAX tree name, netD with
# lambda_GAN > 0
ALL_NETS = dict(NETS, D="netD")


def net_state_from_jax(model, name: str,
                       tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX tree of network ``name`` ("G", "F", "R" or "D": parameters,
    or Adam moments of them) as a state_dict of ``model`` (a
    ``RegistrationModel``)."""
    cfg = model.cfg
    if name == "G":
        if isinstance(model.netG, ResnetGenerator):
            return netG_state_from_jax(tree, model.netG.specs,
                                       use_dropout=not cfg.no_dropout)
        return state_from_flax(model.netG, tree)
    if name == "F":
        if isinstance(model.netF, PatchSampleF):
            return netF_state_from_jax(tree)
        sd = state_from_flax(model.netF, tree)
        # StridedConvF's EMA: zeros in the JAX engine, never saved
        sd.update({k: torch.zeros_like(v, device="cpu")
                   for k, v in model.netF.named_buffers()})
        return sd
    if name == "R":
        if isinstance(model.netR, VxmDense):
            return netR_state_from_jax(tree, cfg.vxm_enc, cfg.vxm_dec)
        return state_from_flax(model.netR, tree)
    if name == "D" and model.netD is not None:
        if isinstance(model.netD, (NLayerDiscriminator, PixelDiscriminator)):
            return netD_state_from_jax(tree, model.netD)
        return state_from_flax(model.netD, tree)
    raise KeyError(f"no network {name!r} in the port's RegistrationModel")


def load_jax_params(model, params: Mapping[str, Any]) -> None:
    """Load a JAX ``{"G": ..., "F": ..., "R": ...}`` param tree (numpy
    leaves, and ``"D"`` with lambda_GAN > 0) into a ``RegistrationModel``'s
    networks, strictly: every weight of each network must be given."""
    for name, attr in ALL_NETS.items():
        if getattr(model, attr) is not None:
            load_strict(getattr(model, attr),
                        net_state_from_jax(model, name, params[name]))


def _adam_state(optimizer, count, moments) -> dict:
    """A state_dict of ``optimizer`` from optax's one ``count`` and
    ``moments``, ``[(module, mu state_dict, nu state_dict)]`` in the
    optimizer's parameter order.  Optax's ``scale_by_adam`` and torch's
    Adam agree in bias correction and in eps outside the square root, so
    the map is exact."""
    step = float(np.asarray(count))
    state, index = {}, 0
    for net, mu, nu in moments:
        for key, _ in net.named_parameters():
            state[index] = {"step": torch.tensor(step, dtype=torch.float32),
                            "exp_avg": mu[key], "exp_avg_sq": nu[key]}
            index += 1
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def adam_state_from_jax(opt_state: Mapping[str, Any], model) -> dict:
    """An optax ``ScaleByAdamState`` over ``{G, F, R}`` (as a state dict:
    ``count``, ``mu``, ``nu``; numpy leaves) as a state_dict of
    ``model.optimizer``: per parameter ``step`` (optax's one count),
    ``exp_avg`` (mu) and ``exp_avg_sq`` (nu), through the parameters' own
    key and layout maps."""
    return _adam_state(model.optimizer, opt_state["count"], [
        (getattr(model, attr),
         net_state_from_jax(model, name, opt_state["mu"][name]),
         net_state_from_jax(model, name, opt_state["nu"][name]))
        for name, attr in NETS.items()])


def adam_states_from_jax(opt_state: Mapping[str, Any], model) -> dict:
    """JAX's optimizer state as ``{"optimizer": ..., "optimizer_D": ...}``
    state_dicts of ``model``'s two Adams: with lambda_GAN > 0 the JAX
    engine keeps ``(opt_gfr, opt_d)`` (a flax checkpoint writes the pair
    as ``{"0": ..., "1": ...}``), else one ``ScaleByAdamState`` over
    {G, F, R}."""
    if "0" not in opt_state:
        return {"optimizer": adam_state_from_jax(opt_state, model)}
    gfr, d = opt_state["0"], opt_state["1"]
    return {"optimizer": adam_state_from_jax(gfr, model),
            "optimizer_D": _adam_state(model.optimizer_D, d["count"], [
                (model.netD, netD_state_from_jax(d["mu"], model.netD),
                 netD_state_from_jax(d["nu"], model.netD))])}


def vxm_adam_state_from_jax(opt_state: Mapping[str, Any], engine) -> dict:
    """The JAX ``VxmEngine``'s optax ``ScaleByAdamState`` over netR's
    params (``count``, ``mu``, ``nu``) as a state_dict of
    ``engine.optimizer``, as ``adam_state_from_jax`` maps the 2-D one."""
    enc, dec = engine.cfg.enc, engine.cfg.dec
    return _adam_state(engine.optimizer, opt_state["count"], [
        (engine.netR, netR_state_from_jax(opt_state["mu"], enc, dec),
         netR_state_from_jax(opt_state["nu"], enc, dec))])


# flax's msgpack extension types (flax/serialization.py::_MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _unchunk(tree):
    """flax's chunked form of arrays over 1 GiB, back to arrays."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> Any:
    """The tree of dicts, lists, scalars and numpy arrays in a file flax's
    ``msgpack_serialize`` wrote (a JAX checkpoint)."""
    try:
        import msgpack
    except ImportError as err:
        raise ImportError(f"reading the JAX checkpoint {path} needs the "
                          f"msgpack package, which is not installed") from err

    def ext_hook(code, data):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = msgpack.unpackb(data, raw=True)
            dtype = dtype.decode()
            if dtype == "bfloat16":
                raise ValueError(f"{path}: bfloat16 arrays are not read")
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            re, im = msgpack.unpackb(data)
            return complex(re, im)
        raise ValueError(f"{path}: unknown msgpack extension type {code}")

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def load_jax_vxm_params(engine, params: Mapping[str, Any]) -> None:
    """Load a JAX ``VxmEngine`` param tree (``state.params``, numpy leaves)
    into a ``VxmEngine``'s netR, strictly, at 2-D or 3-D."""
    load_strict(engine.netR, netR_state_from_jax(params, engine.cfg.enc,
                                                  engine.cfg.dec))
