"""The port stands alone: importing every module of dfmir_tpu_torch loads
no JAX, Flax, Optax or dfmir_tpu module, and neither its source nor
chip_smoke.py imports one.  Every module also imports, and the training
command line answers --help, with PIL and msgpack blocked: the card's
path needs neither (PIL only resizes, msgpack only reads JAX
checkpoints)."""

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dfmir_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
for blocked in BLOCKED:
    sys.modules[blocked] = None     # an import of it raises ImportError
import dfmir_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dfmir_tpu_torch.__path__,
                                               "dfmir_tpu_torch.")]
for name in names:
    importlib.import_module(name)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "dfmir_tpu"))
print(json.dumps({"modules": names, "banned": banned}))
"""


MODULES = ("ops.warp_cuda", "engine.registration", "engine.schedules",
           "engine.vxm_engine", "nets.patch_sample", "losses.nce",
           "losses.similarity", "losses.regularizers", "train", "test",
           "evaluate", "engine.checkpoints", "compat.convert",
           "options.base_options", "options.train_options",
           "options.test_options", "data.image_folder", "data.transforms",
           "data.unaligned", "data.loader", "models.registration",
           "utils.png", "utils.util", "utils.html", "utils.visualizer",
           "utils.jac_vis", "metrics.segmentation", "metrics.image",
           "parallel.mesh", "parallel.launch", "parallel.checks",
           "nets.factory", "nets.feature_nets", "nets.transfusion",
           "nets.unet_gen", "nets.munit", "nets.stylegan2")


def probe(blocked=()):
    code = f"BLOCKED = {list(blocked)!r}\n" + _PROBE
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_import_loads_no_jax_or_reference_package():
    seen = probe()
    for name in MODULES:
        assert f"dfmir_tpu_torch.{name}" in seen["modules"], name
    assert seen["banned"] == []


def test_imports_without_pil_or_msgpack():
    seen = probe(blocked=("PIL", "msgpack"))
    for name in MODULES:
        assert f"dfmir_tpu_torch.{name}" in seen["modules"], name
    assert seen["banned"] == []


def test_train_help_without_pil_or_msgpack():
    code = ("import sys\n"
            "sys.modules['PIL'] = sys.modules['msgpack'] = None\n"
            "from dfmir_tpu_torch import train\n"
            "train.main(['--help'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--dataroot", "--gpu_ids", "--continue_train",
                 "--n_epochs_decay", "--save_epoch_freq"):
        assert flag in proc.stdout


_BANNED_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|flax|optax)\b"
    r"|from\s+(jax|jaxlib|flax|optax)\b"
    r"|import\s+dfmir_tpu(\.|\s|$)"
    r"|from\s+dfmir_tpu(\.|\s))", re.M)


def test_source_imports_no_jax_or_reference_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert all(f.is_file() for f in files)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _BANNED_IMPORT.finditer(f.read_text())]
    assert hits == []
