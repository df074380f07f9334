"""The port stands alone: importing every module of dfmir_tpu_torch loads
no JAX, Flax, Optax or dfmir_tpu module, and neither its source nor
chip_smoke.py imports one."""

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dfmir_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
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


def test_import_loads_no_jax_or_reference_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("ops.warp_cuda", "engine.registration", "engine.schedules",
                 "engine.vxm_engine", "nets.patch_sample", "losses.nce",
                 "losses.similarity", "losses.regularizers"):
        assert f"dfmir_tpu_torch.{name}" in seen["modules"], name
    assert seen["banned"] == []


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
