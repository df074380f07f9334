"""Loader-side composable transform pipelines in numpy (the JAX package's
``data/image_transforms.py``, which imports only numpy; the reference's
random-augmentation library, util/image_transforms.py:32-780): parameter
objects, seg-aware geometric ``Compose`` pipelines with exact inverses,
intensity normalisations, centre / explicit multi-image cropping with
pad-if-needed, and diffeomorphic / rotation augmentation that warps every
image of a sample with one shared field; label maps (``mask_flag``)
resample with the nearest neighbour, so that label values survive.

They run in the loader's threads on numpy arrays, before a batch reaches
the card; ``ops/augment.py`` is the device-side counterpart.  Vectorised
numpy: no per-pixel Python loop, no scipy ``griddata`` (nearest resampling
on a regular grid is a rounded index lookup).

Randomness: every sampler takes an optional ``rng`` (a
``numpy.random.Generator``); without one it draws from ``numpy.random``'s
module state, so the reference's ``np.random.seed`` reproducibility holds.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def _rng(rng):
    return np.random if rng is None else rng


def _as_pair(v, n=2):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


# ---------------------------------------------------------------- samplers
# Parameter objects (reference image_transforms.py:32-256): they hold the
# distribution config and sample concrete fields/matrices.


class ResizeParams:
    def __init__(self, resize_shape):
        self.resize_shape = _as_pair(resize_shape)


class CropParams:
    def __init__(self, crop_shape, init_coordinates=None):
        self.crop_shape = _as_pair(crop_shape)
        self.init_coordinates = init_coordinates


class FlipParams:
    pass


class PadParams:
    def __init__(self, psize, pfill=0, pmode="constant", dim=2):
        self.psize = _as_pair(psize, dim)
        self.pfill = pfill
        self.pmode = pmode
        self.dim = dim


def _sample_scalar(distribution, value_range, size, rng=None):
    """Shared draw for NonLinear/Rotation params: value_range is
    (spread, center) for 'normal'/'lognormal', (low, high) for 'uniform'
    (reference image_transforms.py:58-107)."""
    r = _rng(rng)
    if distribution == "normal":
        std, mean = value_range[0], value_range[1]
        return r.standard_normal(size) * std + mean
    if distribution == "uniform":
        low, high = value_range[0], value_range[1]
        return r.random(size) * (high - low) + low
    if distribution == "lognormal":
        std, mean = value_range[0], value_range[1]
        return np.exp(r.standard_normal(size) * std + mean)
    if distribution is None:
        return np.asarray([value_range] * size, np.float64).reshape(size)
    raise ValueError(f"unknown distribution {distribution!r}")


class NonLinearParams:
    """Low-res SVF sampler (reference :57-108)."""

    def __init__(self, lowres_size, lowres_strength=1,
                 distribution="normal", nstep=5):
        self.lowres_size = tuple(lowres_size)
        self.lowres_strength = lowres_strength
        self.distribution = distribution
        self.nstep = nstep

    def get_lowres_strength(self, ndim=2, rng=None):
        r = _rng(rng)
        strength = _sample_scalar(self.distribution, self.lowres_strength,
                                  1, rng)
        size = self.lowres_size[:ndim]
        if len(size) < ndim:
            size = size * ndim
        return tuple(strength * r.standard_normal(size)
                     for _ in range(ndim))


class RotationParams:
    """Rotation-angle sampler -> centered affine (reference :110-140)."""

    def __init__(self, value_range, distribution="uniform"):
        self.value_range = value_range
        self.distribution = distribution

    def get_angles(self, ndim=2, rng=None):
        size = 1 if ndim == 2 else 3
        return _sample_scalar(self.distribution, self.value_range, size,
                              rng)


class AffineParams:
    """Full affine sampler: per-axis rotation (deg) / scaling / translation
    composed center-out, T_trans @ T_center @ R @ S @ T_-center
    (reference :142-255)."""

    def __init__(self, rotation, scaling, translation):
        self.rotation = rotation
        self.scaling = scaling
        self.translation = translation

    def get_affine(self, image_shape, rng=None):
        r = _rng(rng)
        nd = len(image_shape)
        angles = [(2 * r.random() - 1) * a / 180.0 * np.pi
                  for a in self.rotation]
        scales = [1 + (2 * r.random() - 1) * s for s in self.scaling]
        trans = [(2 * r.random() - 1) * t for t in self.translation]
        return compose_centered_affine(image_shape, angles, scales, trans)


def _rot2(a):
    return np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])


def compose_centered_affine(image_shape, angles, scales, translation):
    """(nd+1, nd+1) homogeneous matrix: translate to center, scale, rotate
    (2-D one angle; 3-D X-Y-Z Euler), translate back, then shift."""
    nd = len(image_shape)
    center = np.asarray(image_shape, np.float64) / 2.0
    A = np.diag(np.asarray(scales, np.float64))
    if nd == 2:
        A = _rot2(angles[0]) @ A
    else:
        for axis, a in enumerate(angles):
            R3 = np.eye(3)
            ix = [i for i in range(3) if i != axis]
            R2 = _rot2(a)
            for ri, gi in enumerate(ix):
                for ci, gj in enumerate(ix):
                    R3[gi, gj] = R2[ri, ci]
            A = R3 @ A
    M = np.eye(nd + 1)
    M[:nd, :nd] = A
    M[:nd, nd] = (center - A @ center
                  + np.asarray(translation, np.float64))
    return M


# -------------------------------------------------------- interpolation

def bilinear_interpolate(im, x, y):
    """Vectorized border-clamped bilinear sample of 2-D ``im`` at (x=cols,
    y=rows) (reference util/image_utils.py:100-131 semantics)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x0c = np.clip(x0, 0, im.shape[1] - 1)
    x1c = np.clip(x0 + 1, 0, im.shape[1] - 1)
    y0c = np.clip(y0, 0, im.shape[0] - 1)
    y1c = np.clip(y0 + 1, 0, im.shape[0] - 1)
    wa = (x0 + 1 - x) * (y0 + 1 - y)
    wb = (x0 + 1 - x) * (y - y0)
    wc = (x - x0) * (y0 + 1 - y)
    wd = (x - x0) * (y - y0)
    return (wa * im[y0c, x0c] + wb * im[y1c, x0c]
            + wc * im[y0c, x1c] + wd * im[y1c, x1c])


def nearest_interpolate(im, x, y):
    """Nearest-neighbor lookup (label-safe; replaces the reference's
    scipy griddata-nearest over a regular grid, image_transforms.py:672)."""
    xi = np.clip(np.rint(np.asarray(x)).astype(int), 0, im.shape[1] - 1)
    yi = np.clip(np.rint(np.asarray(y)).astype(int), 0, im.shape[0] - 1)
    return im[yi, xi]


def _resize_bilinear(im, out_shape):
    """align_corners-style bilinear resize of a 2-D array."""
    H, W = im.shape[:2]
    oh, ow = out_shape
    ys = np.linspace(0, H - 1, oh) if oh > 1 else np.zeros(1)
    xs = np.linspace(0, W - 1, ow) if ow > 1 else np.zeros(1)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    if im.ndim == 2:
        return bilinear_interpolate(im, xx, yy)
    return np.stack([bilinear_interpolate(im[..., c], xx, yy)
                     for c in range(im.shape[-1])], axis=-1)


# -------------------------------------------------------- geometric chain


class Resize:
    def __init__(self, parameters: ResizeParams):
        self.resize_shape = parameters.resize_shape

    def __call__(self, data):
        return _resize_bilinear(np.asarray(data, np.float64),
                                self.resize_shape)


class Padding:
    """Center-pad to ``psize`` (floor/ceil split on odd margins; reference
    image_transforms.py:471-513).  ``inverse`` crops the pad back off."""

    def __init__(self, parameters: PadParams, isize, dim=2):
        if len(isize) > dim + 1:
            raise ValueError("specify a valid dimension and size")
        pads = []
        for i, o in zip(isize, parameters.psize):
            extra = max(o - i, 0)
            pads.append((extra // 2, extra - extra // 2))
        self.padding = pads
        self.fill = parameters.pfill
        self.padding_mode = parameters.pmode
        self.dim = dim

    def _pad_one(self, a):
        kw = ({"constant_values": self.fill}
              if self.padding_mode == "constant" else {})
        return np.pad(a, self.padding, mode=self.padding_mode, **kw)

    def __call__(self, data):
        data = np.asarray(data)
        if data.ndim == self.dim + 1:   # trailing channel axis
            return np.stack([self._pad_one(data[..., c])
                             for c in range(data.shape[-1])], axis=-1)
        return self._pad_one(data)

    def inverse(self, data, img_shape):
        sl = tuple(slice(p0, p0 + s)
                   for (p0, _), s in zip(self.padding, img_shape))
        return np.asarray(data)[sl]


class RandomCropManyImages:
    """Crop every array of a sample at the SAME location (center by
    default, or explicit ``init_coordinates``), padding any array smaller
    than the crop first; ``inverse`` re-pads the crop back into the
    original geometry (reference image_transforms.py:515-622)."""

    def __init__(self, parameters: CropParams, pad_if_needed=True, fill=0,
                 padding_mode="constant"):
        self.parameters = parameters
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def get_params(self, data_shape, output_shape):
        if all(a == b for a, b in zip(data_shape, output_shape)):
            return [0] * len(data_shape), tuple(data_shape)
        init = self.parameters.init_coordinates
        if init is None:
            init = [int((a - b) / 2)
                    for a, b in zip(data_shape, output_shape)]
        return list(init), tuple(output_shape)

    def _pad_small(self, data, size):
        pad = [(max(s - d, 0), 0) for d, s in zip(data.shape, size)]
        pad += [(0, 0)] * (data.ndim - len(size))
        if not self.pad_if_needed or not any(p[0] for p in pad):
            return data
        kw = ({"constant_values": self.fill}
              if self.padding_mode == "constant" else {})
        return np.pad(data, pad, mode=self.padding_mode, **kw)

    def __call__(self, data_list):
        size = self.parameters.crop_shape
        padded = [self._pad_small(np.asarray(d), size) for d in data_list]
        init, out_shape = self.get_params(padded[0].shape, size)
        self.init_coord, self.output_shape = init, out_shape
        sl = tuple(slice(i, i + s) for i, s in zip(init, out_shape))
        return [d[sl] for d in padded]

    def inverse(self, data_list, data_shape):
        size = self.parameters.crop_shape
        init, _ = self.get_params(data_shape[0], size)
        out = []
        for data, dshape in zip(data_list, data_shape):
            data = np.asarray(data)
            # drop the pad-if-needed rows/cols first
            sl = tuple(slice(max(s - t, 0), max(s - t, 0) + t)
                       for s, t in zip(size, dshape))
            data = data[sl]
            pad = [(int(i), int(t - min(s, t) - i)) if s < t else (0, 0)
                   for i, s, t in zip(init, size, dshape)]
            pad += [(0, 0)] * (data.ndim - len(size))
            out.append(np.pad(data, pad, mode=self.padding_mode,
                              constant_values=self.fill))
        return out


class Compose:
    """Geometric pipeline over a LIST of same-sample arrays (image + seg
    maps): every array gets the identical crop/pad/resize, and ``inverse``
    maps network outputs back to the original geometry (reference
    image_transforms.py:257-337)."""

    def __init__(self, transform_parameters):
        self.transform_parameters = transform_parameters or []
        self.img_shape = None

    def _compute_data_shape(self, init_shape):
        self.img_shape = init_shape
        final = init_shape
        n = len(init_shape) if isinstance(init_shape, list) else 1
        for t in self.transform_parameters:
            if isinstance(t, CropParams):
                final = [t.crop_shape] * n
            elif isinstance(t, PadParams):
                final = init_shape if t.psize is None else [t.psize] * n
            elif isinstance(t, ResizeParams):
                final = [t.resize_shape] * n
            else:
                raise ValueError(f"{type(t)} is not a valid transformation")
        return final if isinstance(init_shape, list) else final[0]

    def __call__(self, img: List[np.ndarray]):
        self.img_shape = [np.asarray(i).shape for i in img]
        for t in self.transform_parameters:
            if isinstance(t, CropParams):
                img = RandomCropManyImages(t)(img)
            elif isinstance(t, PadParams):
                img = [Padding(t, np.asarray(i).shape)(i) for i in img]
            elif isinstance(t, ResizeParams):
                img = [Resize(t)(i) for i in img]
            else:
                raise ValueError(f"{type(t)} is not a valid transformation")
        return img

    def inverse(self, img, img_shape=None):
        if img_shape is None:
            if self.img_shape is None:
                raise ValueError(
                    "provide the initial image shape or call the forward "
                    "transform before calling the inverse")
            img_shape = self.img_shape
        # trace the per-stage shapes forward, then undo transforms in
        # reverse, each against the shape it saw going in
        stage_shapes = [list(img_shape)]
        for t in self.transform_parameters:
            prev = stage_shapes[-1]
            if isinstance(t, CropParams):
                nxt = [t.crop_shape + tuple(s[len(t.crop_shape):])
                       for s in prev]
            elif isinstance(t, PadParams):
                nxt = [tuple(max(o, i) for o, i in zip(t.psize, s))
                       + tuple(s[len(t.psize):]) for s in prev]
            elif isinstance(t, ResizeParams):
                nxt = [t.resize_shape + tuple(s[len(t.resize_shape):])
                       for s in prev]
            else:
                raise ValueError(f"{type(t)} is not a valid transformation")
            stage_shapes.append(nxt)
        for t, pre in zip(reversed(self.transform_parameters),
                          reversed(stage_shapes[:-1])):
            if isinstance(t, CropParams):
                img = RandomCropManyImages(t).inverse(img, pre)
            elif isinstance(t, PadParams):
                img = [Padding(t, s).inverse(i, s)
                       for i, s in zip(img, pre)]
            else:
                raise ValueError(
                    f"{type(t)} has no inverse in this pipeline")
        return img


# ----------------------------------------------------- intensity transforms


class Normalization:
    """Chains intensity normalizations (reference :376-390)."""

    def __init__(self, normalization_list):
        if normalization_list is None:
            normalization_list = []
        if not isinstance(normalization_list, list):
            normalization_list = [normalization_list]
        self.normalization_list = normalization_list

    def __call__(self, data, *a, **kw):
        for n in self.normalization_list:
            data = n(data)
        return data


class NormalNormalization:
    """Z-score then re-center/scale to (mean, std) (reference :402-422)."""

    def __init__(self, mean=0, std=1, dim=None, inplace=False):
        self.mean = mean
        self.std = std
        self.dim = dim

    def __call__(self, data, *a, **kw):
        data = np.asarray(data, np.float64)
        m = np.mean(data, axis=self.dim, keepdims=self.dim is not None)
        s = np.std(data, axis=self.dim, keepdims=self.dim is not None)
        return ((data - m) / np.maximum(s, 1e-12) + self.mean) * self.std


class DeMean:
    def __call__(self, data, *a, **kw):
        data = np.asarray(data, np.float64)
        return data - np.mean(data)


class ScaleNormalization:
    """Range mode: affinely map [dmin, dmax] (exact or contrast-quantile,
    over an optional foreground mask) onto ``range`` and clip; scale mode:
    multiply (masked) voxels by ``scale`` (reference :433-469)."""

    def __init__(self, scale=1.0, dtype="float64", range=None,
                 quantile=False, contrast=(0.99, 0.01)):
        self.scale = scale
        self.range = range
        self.quantile = quantile
        self.dtype = dtype
        self.contrast = contrast

    def get_mask_value(self, data):
        if self.range is not None:
            return self.range[0]
        return np.min(data) * self.scale

    def __call__(self, data, mask=None, *a, **kw):
        data = np.array(data)
        mask = (np.ones_like(data, bool) if mask is None
                else np.asarray(mask) > 0)
        if self.range is None:
            data[mask] = data[mask] * self.scale
            return data
        vals = data[mask]
        if self.quantile:
            dmax = np.quantile(vals, self.contrast[0])
            dmin = np.quantile(vals, self.contrast[1])
        else:
            dmax, dmin = np.max(vals), np.min(vals)
        data = data.astype(self.dtype)
        data = ((data - dmin) / max(dmax - dmin, 1e-12)
                * (self.range[1] - self.range[0]) + self.range[0])
        return np.clip(data, self.range[0], self.range[1])


# ------------------------------------------------------- data augmentation


class NonLinearDeformationManyImages:
    """Warp every array of a sample with one shared dense field;
    ``mask_flag[i]`` selects nearest-neighbor resampling (label maps)
    (reference :623-672)."""

    def __init__(self, params: NonLinearParams, output_flow=False,
                 reverse_field=False, rng=None):
        self.params = params
        self.output_flow = output_flow
        self.reverse_field = reverse_field
        self.rng = rng

    def _get_lowres_strength(self):
        return self.params.get_lowres_strength(ndim=2, rng=self.rng)

    def __call__(self, data, mask_flag, XX, YY, flow_x, flow_y, *a, **kw):
        x, y = XX + flow_x, YY + flow_y
        out = []
        for image, is_mask in zip(data, mask_flag):
            image = np.asarray(image)
            if is_mask:
                out.append(nearest_interpolate(image, x, y))
            else:
                out.append(bilinear_interpolate(image, x, y))
        return out


class NonLinearDifferomorphismManyImages(NonLinearDeformationManyImages):
    """Diffeomorphic variant: low-res SVF, bilinear upsample, scaling-and-
    squaring integration (nstep), then the shared warp (reference
    :674-716).  Name kept [sic] for surface parity."""

    def get_diffeomorphism(self, lowres_fields, image_shape, reverse=False):
        fx = _resize_bilinear(np.asarray(lowres_fields[0], np.float64),
                              image_shape)
        fy = _resize_bilinear(np.asarray(lowres_fields[1], np.float64),
                              image_shape)
        YY, XX = np.meshgrid(np.arange(image_shape[0]),
                             np.arange(image_shape[1]), indexing="ij")
        scale = -1.0 if reverse else 1.0
        flow_x = scale * fx / (2 ** self.params.nstep)
        flow_y = scale * fy / (2 ** self.params.nstep)
        for _ in range(self.params.nstep):
            x = XX + flow_x
            y = YY + flow_y
            flow_x = flow_x + bilinear_interpolate(flow_x, x, y)
            flow_y = flow_y + bilinear_interpolate(flow_y, x, y)
        return XX, YY, flow_x, flow_y

    def __call__(self, data, mask_flag, *a, **kw):
        image_shape = np.asarray(data[0]).shape
        low = self._get_lowres_strength()
        XX, YY, flow_x, flow_y = self.get_diffeomorphism(low, image_shape)
        out = super().__call__(data, mask_flag, XX, YY, flow_x, flow_y)
        if not self.output_flow:
            return out
        if self.reverse_field:
            XX, YY, flow_x, flow_y = self.get_diffeomorphism(
                low, image_shape, reverse=True)
        return out, np.stack([flow_x, flow_y], axis=0)


class Rotation:
    """Centered-rotation augmentation of a sample list (nearest for
    flagged label maps); can also emit the dense displacement field
    (reference :718-780)."""

    def __init__(self, params: RotationParams, dense_field=False,
                 reverse=True, rng=None):
        self.params = params
        self.dense_field = dense_field
        self.reverse = reverse
        self.rng = rng

    def _get_affine_matrix(self, angle_deg):
        return compose_centered_affine((0.0, 0.0),
                                       [angle_deg / 180.0 * np.pi],
                                       [1.0, 1.0], [0.0, 0.0])

    def _dense_field(self, affine, volshape):
        """Displacement field of a full homogeneous matrix (already
        center-composed): shift = M @ p - p on raw pixel coords."""
        grids = np.meshgrid(*[np.arange(s, dtype=np.float64)
                              for s in volshape], indexing="ij")
        flat = np.stack([g.ravel() for g in grids]
                        + [np.ones(grids[0].size)], axis=0)
        loc = (affine @ flat)[:len(volshape)]
        return (loc.reshape((len(volshape),) + tuple(volshape))
                - np.stack(grids, axis=0))

    def __call__(self, data, mask_flag=None, *a, **kw):
        data = [np.asarray(d) for d in data]
        if mask_flag is None:
            mask_flag = [False] * len(data)
        shape = data[0].shape
        angle = float(self.params.get_angles(ndim=2, rng=self.rng)[0])
        M = compose_centered_affine(
            [s - 1 for s in shape],
            [(-angle if self.reverse else angle) / 180.0 * np.pi],
            [1.0, 1.0], [0.0, 0.0])
        YY, XX = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                             indexing="ij")
        pts = np.stack([YY.ravel(), XX.ravel(),
                        np.ones(YY.size)], axis=0)
        src = (M @ pts)[:2].reshape(2, *shape)
        out = []
        for image, is_mask in zip(data, mask_flag):
            f = nearest_interpolate if is_mask else bilinear_interpolate
            out.append(f(image, src[1], src[0]))
        if self.dense_field:
            shift = self._dense_field(M, shape)
            return out, shift
        return out


class Compose_DA:
    """Data-augmentation pipeline honoring ``mask_flag`` (seg-aware):
    NonLinearParams -> diffeomorphic warp, RotationParams -> rotation
    (reference :339-374)."""

    def __init__(self, data_augmentation_parameters, rng=None):
        self.data_augmentation_parameters = (
            data_augmentation_parameters or [])
        self.rng = rng

    def __call__(self, img, mask_flag=None, **kw):
        islist = isinstance(img, list)
        if not islist:
            img = [img]
        if mask_flag is None:
            mask_flag = [False] * len(img)
        for da in self.data_augmentation_parameters:
            if isinstance(da, NonLinearParams):
                img = NonLinearDifferomorphismManyImages(
                    da, rng=self.rng)(img, mask_flag)
            elif isinstance(da, RotationParams):
                img = Rotation(da, rng=self.rng)(img, mask_flag)
            else:
                raise ValueError(
                    f"{type(da)} is not a valid data augmentation")
        return img if islist else img[0]
