"""Model registry: ``--model <name>`` -> the task class in
``dfmir_tpu_torch.models.<name>`` (the JAX package's
``models/__init__.py``)."""

from __future__ import annotations

import importlib


def find_model_using_name(name: str):
    module = importlib.import_module(f"dfmir_tpu_torch.models.{name}")
    target = name.replace("_", "") + "task"
    for attr in dir(module):
        if attr.lower() == target and isinstance(getattr(module, attr), type):
            return getattr(module, attr)
    raise ImportError(
        f"dfmir_tpu_torch.models.{name} has no class matching {target!r}")


def get_option_setter(name: str):
    return find_model_using_name(name).modify_commandline_options


def create_model(opt):
    cls = find_model_using_name(opt.model)
    instance = cls(opt)
    print(f"model [{type(instance).__name__}] was created")
    return instance
