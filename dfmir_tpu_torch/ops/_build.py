"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use and lands in ``dfmir_tpu_torch/build/``; the library's
name carries a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited file builds anew.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# name -> (restype, argtypes) of every extern "C" entry in csrc/
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    # (src, flow, out, B, C, H, W, stream) -> cudaError_t
    "dfmir_warp2d_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    # (src, flow, g, dsrc or NULL, dflow, scratch, B, C, H, W, stream)
    #  -> cudaError_t
    "dfmir_warp2d_bwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    # (B, C, H, W) -> the int64s of dfmir_warp2d_bwd's scratch
    "dfmir_warp2d_bwd_scratch": (_L, [_I, _I, _I, _I]),
    # (vec, steps, out, B, H, W, nsteps, save, cluster, stream)
    #  -> cudaError_t
    "dfmir_vecint2d_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # (steps, g, sums, dvec, B, H, W, nsteps, cluster, stream)
    "dfmir_vecint2d_bwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # (&cluster, &active) -> cudaError_t
    "dfmir_vecint2d_bwd_clusters": (_I, [_P, _P]),
    # (vec, steps, slot, out, maxes, B, D, H, W, nsteps, save, blocks,
    #  stream)
    "dfmir_vecint3d_fwd": (_I, [_P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _P]),
    # (dims) -> None: {brick z, y, x, most halo, x pad}
    "dfmir_vecint3d_fwd_brick": (None, [_P]),
    # (steps, slot, g, scratch, bins, dvec, B, D, H, W, nsteps, blocks,
    #  stream)
    "dfmir_vecint3d_bwd": (_I, [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _P]),
    # (src, flow, out, B, C, D, H, W, Ds, z0, stream) -> cudaError_t
    "dfmir_warp3d_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    # (src, flow, g, dflow, B, C, D, H, W, Ds, z0, stream) -> cudaError_t
    "dfmir_warp3d_bwd_dflow": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _P]),
    # (flow, g, dsrc, bins, B, C, D, H, W, blocks, stream) -> cudaError_t
    "dfmir_warp3d_bwd_dsrc": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _P]),
    # (B, C, D, H, W, nsteps) -> the int32s of the bins buffer
    "dfmir_bins3d_ints": (_L, [_I, _I, _I, _I, _I, _I]),
}

_lib = None


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME, else the toolkit's
    default install.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdfmir_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        output = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{output}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a library of these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    _run_all([[nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources(), objects)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]])
    for obj in objects:
        obj.unlink()
    os.replace(tmp, out)   # atomic: a concurrent process never loads half a file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry's types set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib
