"""The port's numpy utilities (``utils/patchlib.py``, ``utils/ndutils.py``)
against the JAX package's modules: each scenario through both on the same
inputs, every output equal (the same numpy operations).  And the check
left from the first slice: the port's plain warp (``ops/warp.py::warp``)
against the reference SpatialTransformer, ``dfmir_tpu/compat/
torch_ref.py::RefSTN`` (``F.grid_sample`` on normalised coordinates), in
2-D and 3-D, within 1e-5 max-abs."""

import numpy as np
import pytest
import torch

import dfmir_tpu.utils.ndutils as jnd
import dfmir_tpu.utils.patchlib as jpl
import dfmir_tpu_torch.utils.ndutils as pnd
import dfmir_tpu_torch.utils.patchlib as ppl
from dfmir_tpu.compat.torch_ref import RefSTN
from dfmir_tpu_torch.ops.warp import warp
from torch_threads import few_threads  # noqa: F401 (autouse fixture)


def grids(m, rng):
    return (m.gridsize((10, 12), (4, 4), patch_stride=2, nargout=2),
            m.grid2volsize((4, 5), (4, 4), 2),
            m.grid((9, 9), (3, 3), patch_stride=3),
            m.grid((9, 11), (3, 2), patch_stride=(3, 1), grid_type="sub",
                   nargout=3),
            m.gridsize((7, 8, 9), (2, 3, 4), (1, 2, 3), start_sub=(1, 0, 2)))


def patches_and_quilts(m, rng):
    vol = rng.standard_normal((7, 9))
    out = []
    for stride in (1, 2, 3):
        gs = m.gridsize(vol.shape, (3, 3), stride)
        p = m.patch_gen(vol, (3, 3), stride=stride)
        out += [p, m.quilt(p.reshape(len(p), -1), (3, 3), gs,
                           patch_stride=stride)]
    return out


def quilts_3d_and_stacks(m, rng):
    vol = rng.standard_normal((6, 6, 6))
    lib = m.patch_gen(vol, (2, 2, 2), stride=2).reshape(27, -1)
    lib_k = np.stack([lib, lib * 2.0], axis=-1)
    lib_k[0, 0, 1] = np.nan                  # a missing candidate
    vol2 = rng.standard_normal((8, 8))
    p = m.patch_gen(vol2, (4, 4), stride=2).reshape(9, -1)
    gs = m.gridsize((8, 8), (4, 4), 2)
    return (m.quilt(lib_k, (2, 2, 2), (3, 3, 3), patch_stride=2),
            m.stack(p, (4, 4), gs, 2, nargout=2),
            m.quilt(p, (4, 4), gs, 2, nan_func_layers=np.nanmedian))


def nd_volumes(m, rng):
    seg = np.zeros((20, 20), int)
    seg[4:12, 5:15] = 1
    seg[12:18, 3:9] = 2
    bw = m.bw_sphere((32, 32), 8).astype(bool)
    return (m.bw_grid((16, 16), 4), m.bw_grid((12, 14, 10), (3, 4, 5), 2),
            m.bw_sphere((16, 16, 16), 4), m.bw_sphere((15, 17), 5.5,
                                                       (6, 8)),
            m.gaussian_kernel([1.0, 1.0]), m.gaussian_kernel([1.5, 0.7, 1.0]),
            m.bw2sdtrf(bw), m.bw2sdtrf(m.bw_sphere((12, 12, 12), 4) > 0),
            m.perlin_vol((32, 32), seed=0), m.perlin_vol((16, 20, 12),
                                                         min_scale=1,
                                                         seed=3),
            m.seg2contour(seg), m.seg2contour(seg, thickness=2))


SCENARIOS = [grids, patches_and_quilts, quilts_3d_and_stacks, nd_volumes]


def assert_same(mine, ref, where="out"):
    if isinstance(ref, (list, tuple)):
        assert len(mine) == len(ref), where
        for i, (a, b) in enumerate(zip(mine, ref)):
            assert_same(a, b, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref),
                                      err_msg=where)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_equals_jax_module(scenario):
    mine = scenario({"grids": ppl, "patches_and_quilts": ppl,
                     "quilts_3d_and_stacks": ppl}.get(scenario.__name__, pnd),
                    np.random.default_rng(2))
    ref = scenario({"grids": jpl, "patches_and_quilts": jpl,
                    "quilts_3d_and_stacks": jpl}.get(scenario.__name__, jnd),
                   np.random.default_rng(2))
    assert_same(mine, ref)


@pytest.mark.parametrize("scale,shift", [(1.5, 0.0), (6.0, 0.0),
                                         (3.0, 20.0)])
@pytest.mark.parametrize("shape", [(2, 3, 24, 20), (1, 2, 12, 10, 14)])
def test_warp_matches_ref_stn(shape, scale, shift):
    """identity + flow sampled at pixel coordinates against the reference
    STN's grid_sample(align_corners=True, zeros) round trip through [-1,
    1], some points outside the image (shift)."""
    gen = torch.Generator().manual_seed(0)
    B, C, *spatial = shape
    src = torch.randn(shape, generator=gen)
    flow = torch.randn((B, len(spatial), *spatial),
                       generator=gen) * scale + shift
    ref = RefSTN(spatial)(src, flow)
    out = warp(src, flow, impl="torch")
    assert float((out - ref).abs().max()) <= 1e-5
