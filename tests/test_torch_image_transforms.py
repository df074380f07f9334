"""The port's numpy transform pipelines (``data/image_transforms.py``)
against the JAX package's module (numpy only): each scenario runs through
both with the same inputs and the same seeded ``numpy.random.Generator``,
and every output is equal (the same numpy operations)."""

import numpy as np
import pytest

import dfmir_tpu.data.image_transforms as jit
import dfmir_tpu_torch.data.image_transforms as pit


def padding(m, rng):
    img = rng.standard_normal((5, 8))
    p = m.Padding(m.PadParams((9, 8)), img.shape)
    out = p(img)
    chan = m.Padding(m.PadParams((8, 8)), (5, 6))(
        rng.standard_normal((5, 6, 3)))
    return out, p.inverse(out, img.shape), chan


def crops(m, rng):
    a, b = rng.standard_normal((10, 12)), rng.integers(0, 4, (10, 12))
    crop = m.RandomCropManyImages(m.CropParams((6, 6)))
    ca, cb = crop([a, b])
    small, = m.RandomCropManyImages(m.CropParams((6, 6)))(
        [rng.standard_normal((4, 9))])
    placed = m.RandomCropManyImages(m.CropParams((4, 5), (2, 3)))([a])
    return ca, cb, small, placed, crop.inverse([ca], [a.shape])


def compose(m, rng):
    a, seg = rng.standard_normal((20, 20)), rng.integers(0, 4, (20, 20))
    c = m.Compose([m.CropParams((12, 12)), m.PadParams((16, 16))])
    out = c([a, seg])
    shapes = c._compute_data_shape([(20, 20), (20, 20)])
    resized = m.Compose([m.ResizeParams((8, 11))])(
        [rng.standard_normal((16, 16))])
    return out, c.inverse(out), shapes, resized


def normalizations(m, rng):
    data = rng.random((8, 8)) * 100
    mask = np.zeros((8, 8))
    mask[2:6, 2:6] = 1
    return (m.ScaleNormalization(range=(-1, 1))(data),
            m.ScaleNormalization(range=(0, 1))(data, mask=mask),
            m.ScaleNormalization(range=(0, 1), quantile=True)(data),
            m.ScaleNormalization(scale=2.0)(data),
            m.ScaleNormalization(range=(-1, 1)).get_mask_value(data),
            m.Normalization([m.DeMean(), m.NormalNormalization()])(data))


def diffeomorphism(m, rng):
    img = rng.standard_normal((32, 32))
    seg = rng.integers(0, 5, (32, 32)).astype(np.float64)
    da = m.Compose_DA([m.NonLinearParams((4, 4), lowres_strength=(1.0, 3.0),
                                         nstep=4)], rng=rng)
    out = da([img, seg], mask_flag=[False, True])
    tf = m.NonLinearDifferomorphismManyImages(
        m.NonLinearParams((4, 4), lowres_strength=(0.5, 1.0), nstep=3),
        output_flow=True, rng=rng)
    return out, tf([img], [False])


def shared_field(m, rng):
    img = rng.standard_normal((14, 18))
    seg = rng.integers(0, 3, (14, 18)).astype(np.float64)
    YY, XX = np.meshgrid(np.arange(14.0), np.arange(18.0), indexing="ij")
    fx, fy = (rng.standard_normal((14, 18)) * 1.5 for _ in range(2))
    tf = m.NonLinearDeformationManyImages(
        m.NonLinearParams((4, 4), lowres_strength=(0.5, 2.0)), rng=rng)
    return (tf([img, seg], [False, True], XX, YY, fx, fy),
            tf._get_lowres_strength())


def rotations(m, rng):
    img = rng.standard_normal((16, 16))
    seg = rng.integers(0, 3, (16, 16)).astype(np.float64)
    return (m.Rotation(m.RotationParams(20.0, distribution=None))(
                [img, seg], [False, True]),
            m.Rotation(m.RotationParams(15.0, distribution=None),
                       dense_field=True)([img], [False]),
            m.Rotation(m.RotationParams((-30.0, 30.0)), rng=rng)(
                [img], [False]))


def affine_params(m, rng):
    two = m.AffineParams(rotation=[10.0], scaling=[0.05, 0.05],
                         translation=[2.0, 2.0]).get_affine((32, 32), rng=rng)
    three = m.AffineParams(rotation=[5.0, 5.0, 5.0], scaling=[0.1] * 3,
                           translation=[1.0] * 3).get_affine((16, 16, 16),
                                                             rng=rng)
    fields = m.NonLinearParams((4, 4, 4), lowres_strength=(0.5, 1.0)
                               ).get_lowres_strength(ndim=3, rng=rng)
    return two, three, fields


def interpolations(m, rng):
    im = rng.standard_normal((9, 11))
    x = rng.random((9, 11)) * 12 - 0.5
    y = rng.random((9, 11)) * 10 - 0.5
    return (m.bilinear_interpolate(im, x, y), m.nearest_interpolate(im, x, y),
            m.compose_centered_affine((9, 11), [0.3], [1.1, 0.9],
                                      [1.0, -2.0]))


def compose_da_mixed(m, rng):
    img = rng.standard_normal((24, 24))
    seg = rng.integers(0, 4, (24, 24)).astype(np.float64)
    da = m.Compose_DA([m.NonLinearParams((4, 4), lowres_strength=(0.5, 2.0),
                                         nstep=3),
                       m.RotationParams((-10.0, 10.0))], rng=rng)
    return da([img, seg], mask_flag=[False, True]), da(img)


SCENARIOS = [padding, crops, compose, normalizations, diffeomorphism,
             shared_field, rotations, affine_params, interpolations,
             compose_da_mixed]


def assert_same(mine, ref, where="out"):
    if isinstance(ref, (list, tuple)):
        assert type(mine) is type(ref) and len(mine) == len(ref), where
        for i, (a, b) in enumerate(zip(mine, ref)):
            assert_same(a, b, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref),
                                      err_msg=where)
        assert np.asarray(mine).dtype == np.asarray(ref).dtype, where


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_equals_jax_module(scenario):
    mine = scenario(pit, np.random.default_rng(13))
    ref = scenario(jit, np.random.default_rng(13))
    assert_same(mine, ref)


def test_same_public_names():
    names = {n for n in dir(jit) if not n.startswith("__")
             and n not in ("annotations",)}
    assert names <= set(dir(pit))
