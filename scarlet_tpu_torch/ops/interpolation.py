"""Interpolation and resampling.

1D shift kernels (bilinear, cubic splines, Lanczos, quintic), separable 2D
kernels, image projection helpers, WCS geometry helpers, and band-limited
sinc resampling.  Port of ``scarlet_tpu/ops/interpolation.py``: the
geometry and the 1D kernels are host numpy, as there; the sinc resampler
is torch, and runs in float64: it serves the host precomputations of the
multi-resolution renderers and the model frame's PSF, which the JAX
package computes with 64-bit mode on in its tests.

``interpolate_observation`` resamples an observation's images onto a
model frame, optionally after the wavelet denoiser; the pixel-integration
helpers (``get_common_padding``, ``subsample_function``,
``apply_2D_trapezoid_rule``) are host numpy and ``sinc2D`` float32 torch.

Behavioral reference: scarlet/interpolation.py (file:line cited per function).
"""
from __future__ import annotations

import numpy as np
import torch

from . import fft as fft_ops

__all__ = [
    "get_filter_coords",
    "get_filter_bounds",
    "get_projection_slices",
    "project_image",
    "common_projections",
    "bilinear",
    "cubic_spline",
    "catmull_rom",
    "mitchel_netravali",
    "lanczos",
    "quintic_spline",
    "get_separable_kernel",
    "mk_shifter",
    "get_affine",
    "get_pixel_size",
    "get_angles",
    "sinc_interp",
    "sinc_interp_inplace",
    "get_common_padding",
    "subsample_function",
    "apply_2D_trapezoid_rule",
    "get_psf_size",
    "sinc2D",
    "interpolate_observation",
]

mk_shifter = fft_ops.mk_shifter


# ---------------------------------------------------------------------------
# Real-space filter geometry (used by the real-space convolution path)
# ---------------------------------------------------------------------------
def get_filter_coords(filter_values, center=None):
    """(y, x) offsets of each filter pixel relative to its center.

    Ref: scarlet/interpolation.py:7-41.
    """
    filter_values = np.asarray(filter_values)
    if filter_values.ndim != 2:
        raise ValueError("expected a 2D filter image")
    fh, fw = filter_values.shape
    if center is None:
        if fh % 2 == 0 or fw % 2 == 0:
            raise ValueError(
                "Ambiguous center of even-shaped `filter_values`; pass `center`."
            )
        center = (fh // 2, fw // 2)
    grid = np.indices((fh, fw))            # (2, fh, fw): [y, x] planes
    grid -= np.asarray(center).reshape(2, 1, 1)
    return np.moveaxis(grid, 0, -1)        # (fh, fw, 2) of (dy, dx)


def get_filter_bounds(coords):
    """Start/end clip amounts per filter tap for shifted-block convolution.

    Ref: scarlet/interpolation.py:44-65.
    """
    dy, dx = np.asarray(coords, dtype=int).T
    # positive offsets clip the start, negative ones clip the end
    return (np.clip(dy, 0, None), np.clip(-dy, 0, None),
            np.clip(dx, 0, None), np.clip(-dx, 0, None))


# ---------------------------------------------------------------------------
# Centered projections
# ---------------------------------------------------------------------------
def _axis_overlap(n_in, n_out, start):
    """Paired (frame, image) slices of the overlap between an ``n_in``-pixel
    interval anchored at ``start`` and the frame interval [0, n_out)."""
    lo = max(start, 0)
    hi = min(start + n_in, n_out)
    return slice(lo, hi), slice(lo - start, hi - start)


def get_projection_slices(image, shape, yx0=None):
    """Slices to place ``image`` (centered) into a frame of ``shape``.

    ``yx0`` anchors the image's lower-left corner relative to the frame
    center (``shape // 2``); by default the image center lands there.
    Returns ``(frame_slices, image_slices, (bottom, top, left, right))``
    such that ``frame[frame_slices] = image[image_slices]`` clips exactly.

    Behavioral parity: scarlet/interpolation.py:68-116 (restructured as a
    per-axis interval intersection).
    """
    iNy, iNx = image.shape
    if yx0 is None:
        yx0 = (-(iNy // 2), -(iNx // 2))
    bottom = yx0[0] + (shape[0] >> 1)
    left = yx0[1] + (shape[1] >> 1)
    yslice, iyslice = _axis_overlap(iNy, shape[0], bottom)
    xslice, ixslice = _axis_overlap(iNx, shape[1], left)
    return ((yslice, xslice), (iyslice, ixslice),
            (bottom, bottom + iNy, left, left + iNx))


def project_image(image, shape, yx0=None):
    """Center ``image`` in a zero frame of ``shape`` (pads or trims).

    Ref: scarlet/interpolation.py:119-146.
    """
    image = torch.as_tensor(image)
    frame_bb, image_bb, _ = get_projection_slices(image, shape, yx0)
    out = image.new_zeros(tuple(shape))
    out[frame_bb] = image[image_bb]
    return out


def common_projections(img1, img2):
    """Project two centered images onto their common (max) shape.

    Ref: scarlet/interpolation.py:149-173.
    """
    shape = tuple(max(a, b) for a, b in zip(img1.shape, img2.shape))
    return project_image(img1, shape), project_image(img2, shape)


# ---------------------------------------------------------------------------
# 1D interpolation kernels (host-side: scalar fractional shifts)
# ---------------------------------------------------------------------------
def _check_fractional(dx):
    if abs(dx) > 1:
        raise ValueError(f"fractional shift must lie in [-1, 1], got {dx}")


def bilinear(dx):
    """2-tap linear kernel for fractional shift ``dx``.

    Ref: scarlet/interpolation.py:176-202.
    """
    _check_fractional(dx)
    window = np.arange(2) if dx >= 0 else np.arange(-1, 1)
    frac = dx - window[0]
    return np.array([1 - frac, frac]), window


def cubic_spline(dx, a=1, b=0):
    """4-tap cubic spline kernel (Keys family). Ref: interpolation.py:205-250."""
    _check_fractional(dx)
    window = (np.arange(-1, 3) + np.floor(dx)).astype(int)
    x = np.abs(dx - window)
    # Horner forms of the Keys piecewise cubics on |x|<=1 and 1<|x|<2
    near = ((12 - 6 * a - 9 * b) / 6 * x + (6 * a + 12 * b - 18) / 6) \
        * x * x + (6 - 2 * b) / 6
    far = (((-6 * a - b) / 6 * x + (30 * a + 6 * b) / 6) * x
           + (-48 * a - 12 * b) / 6) * x + (24 * a + 8 * b) / 6
    result = np.select([x <= 1, x < 2], [near, far], default=0.0)
    return result, window


def catmull_rom(dx):
    """Cubic spline with a=0.5, b=0. Ref: interpolation.py:253-258."""
    return cubic_spline(dx, a=0.5, b=0)


def mitchel_netravali(dx):
    """Cubic spline with a=b=1/3. Ref: interpolation.py:261-267."""
    ab = 1 / 3
    return cubic_spline(dx, a=ab, b=ab)


def lanczos(dx, a=3):
    """2a-tap Lanczos kernel. Ref: interpolation.py:270-289."""
    _check_fractional(dx)
    window = (np.arange(1 - a, a + 1) + np.floor(dx)).astype(int)
    t = dx - window
    return np.sinc(t) * np.sinc(t / a), window


def quintic_spline(dx, dtype=np.float64):
    """7-tap quintic spline kernel. Ref: interpolation.py:292-309."""
    window = np.arange(-3, 4)
    x = np.abs(dx - window)
    # the three quintic segments, factored as (quadratic) x (cubic prefactor)
    near = ((-55 * x + 138) * x - 95) * (x ** 3 / 12) + 1
    mid = (((55 * x - 249) * x + 348) * x - 138) * ((x - 1) * (x - 2) / 24)
    far = ((-11 * x + 50) * x - 54) * ((x - 2) * (x - 3) ** 2 / 24)
    result = np.select([x <= 1, x <= 2, x <= 3], [near, mid, far],
                       default=0.0)
    return result, window


def get_separable_kernel(dy, dx, kernel=lanczos, **kwargs):
    """Outer product of two 1D kernels. Ref: interpolation.py:312-338."""
    ky, y_window = kernel(dy, **kwargs)
    kx, x_window = kernel(dx, **kwargs)
    return np.multiply.outer(ky, kx), y_window, x_window


# ---------------------------------------------------------------------------
# WCS geometry helpers (host-side, astropy WCS)
# ---------------------------------------------------------------------------
def get_affine(wcs):
    """Affine (PC/CD) matrix of a WCS. Ref: interpolation.py:378-384."""
    try:
        return wcs.wcs.pc
    except AttributeError:
        return wcs.cd


def get_pixel_size(model_affine):
    """Geometric pixel scale: sqrt of the Jacobian determinant.

    Ref: interpolation.py:387-394 — note the reference uses
    ``sqrt(|m00| * |m11 - m01*m10|)``, which underestimates the scale of
    rotated grids by cos(theta) (and mixes deg with deg^2 terms); the
    determinant is the correct pixel area for any orientation.
    """
    model_affine = np.asarray(model_affine)
    return np.sqrt(np.abs(np.linalg.det(model_affine[:2, :2])))


def _grid_direction(wcs):
    """Unit column-sum vector of a WCS affine (the grid's orientation
    proxy used by the reference) and the grid's pixel scale."""
    affine = np.asarray(get_affine(wcs))
    vec = affine.sum(axis=0)[:2]
    return vec / np.hypot(vec[0], vec[1]), get_pixel_size(affine)


def get_angles(frame_wcs, model_wcs):
    """([cos, sin], pixel-ratio) rotation between two WCS grids.

    Ref: interpolation.py:397-424.
    """
    u, frame_pix = _grid_direction(frame_wcs)
    v, model_pix = _grid_direction(model_wcs)
    # cos from the dot product, sin from the 2D cross product (np.cross on
    # 2-vectors is removed in numpy >= 2.0)
    return [u @ v, u[0] * v[1] - u[1] * v[0]], frame_pix / model_pix


# ---------------------------------------------------------------------------
# Band-limited (sinc) resampling, float64
# ---------------------------------------------------------------------------
def _f64(x, device):
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def sinc_interp(images, coord_hr, coord_lr, angle=None, padding=3):
    """Sinc-resample (B, Ny, Nx) ``images`` sampled at ``coord_lr`` onto
    ``coord_hr``, in float64 on the images' device.

    Aligned grids: two dense sinc-matrix products per band.  Rotated
    grids: per-row Fourier shifts, then sinc products.
    Ref: scarlet/interpolation.py:427-502.
    """
    y_hr, x_hr = (np.asarray(c, np.float64) for c in coord_hr)
    y_lr, x_lr = (np.asarray(c, np.float64) for c in coord_lr)
    hy = np.abs(float(y_lr[1] - y_lr[0]))
    hx = np.abs(float(x_lr[1] - x_lr[0]))
    assert hy != 0 and hx != 0
    images = torch.as_tensor(images).to(torch.float64)
    dev = images.device

    if angle is None or (1 - angle[0] < np.finfo(float).eps):
        ky = _f64(np.sinc((y_lr[None, :] - y_hr[:, None]) / hy), dev)
        kx = _f64(np.sinc((x_lr[:, None] - x_hr[None, :]) / hx), dev)
        # (Nyhr, Nylr) @ (Nylr, Nxlr) @ (Nxlr, Nxhr) per band
        return ky @ images.transpose(-2, -1) @ kx

    cos, sin = (float(a) for a in angle)
    fft_shape = fft_ops.good_fft_shape(images, images, padding=padding,
                                       axes=[1, 2])
    X_fft = fft_ops.transform(images, fft_shape, (-2, -1))
    shifter_y, shifter_x = mk_shifter(fft_shape, device=dev)
    yh = _f64(y_hr, dev)[:, None]
    shift_y = torch.exp(shifter_y[None, :] * (-yh * cos))     # (Nyhr, fh)
    shift_x = torch.exp(shifter_x[None, :] * (-yh * sin))     # (Nyhr, fw')
    result_fft = (X_fft[:, None] * shift_y[None, :, :, None]
                  * shift_x[None, :, None, :])
    result_shape = (images.shape[0], len(y_hr), *images.shape[1:])
    shifted = fft_ops.inverse_transform(result_fft, fft_shape, result_shape,
                                        (2, 3))
    shy = _f64(np.sinc((y_lr[None, :] + x_hr[:, None] * sin) / hy), dev)
    shx = _f64(np.sinc((x_lr[None, :] - x_hr[:, None] * cos) / hx), dev)
    # sum over the LR rows, then the LR columns
    result_y = torch.einsum("bimn,km->bikn", shifted, shy)
    return torch.einsum("bikn,kn->bik", result_y, shx)


def sinc_interp_inplace(image, h_image, h_target, angle, pad_shape=None):
    """Sinc-resample a (B, Ny, Nx) cube onto a grid with pixel scale
    ``h_target`` (optionally rotated), in float64.
    Ref: interpolation.py:505-560.
    """
    image = torch.as_tensor(image)
    assert image.ndim == 3, "images should be provided as a (B, Ny, Nx) cube"
    if pad_shape is not None:
        image = fft_ops.zero_pad(image, pad_shape, axes=[-2, -1])

    ny_lr, nx_lr = image.shape[-2:]
    coord_lr = np.array(
        [
            np.arange(ny_lr) - (ny_lr - 1) / 2,
            np.arange(nx_lr) - (nx_lr - 1) / 2,
        ]
    )
    ny_hr = int(np.round(image.shape[-2] * h_image / h_target))
    nx_hr = int(np.round(image.shape[-1] * h_image / h_target))
    if ny_hr % 2 == 0:
        ny_hr += 1
    if nx_hr % 2 == 0:
        nx_hr += 1
    coord_hr = (
        np.array(
            [
                np.arange(ny_hr) - (ny_hr - 1) / 2,
                np.arange(nx_hr) - (nx_hr - 1) / 2,
            ]
        )
        / h_image
        * h_target
    )
    return sinc_interp(image, coord_hr, coord_lr, angle=angle)


def get_common_padding(img1, img2, padding=None):
    """Padding widths placing two centered images on a common frame.

    Ref: interpolation.py:602-638.
    """
    extra = padding or 0
    target = (img1.shape[-2] + img2.shape[-2] + extra,
              img1.shape[-1] + img2.shape[-1] + extra)

    def center_pad(shape):
        # split the deficit per axis, remainder on the high side
        pads = [(d // 2, d - d // 2)
                for d in (target[0] - shape[-2], target[1] - shape[-1])]
        return tuple(pads)

    return center_pad(img1.shape), center_pad(img2.shape)


def subsample_function(y, x, f, dNy, dNx=None, dy=None, dx=None):
    """Evaluate ``f`` on a grid subdivided ``dNy x dNx`` times per pixel.

    Ref: interpolation.py:657-677.
    """
    if dx is None:
        dx = x[1] - x[0]
    if dy is None:
        dy = y[1] - y[0]
    if dNx is None:
        dNx = dNy
    assert dNy % 2 == 0, f"dNy must be even, received {dNy}"
    assert dNx % 2 == 0, f"dNx must be even, received {dNx}"

    def fine_axis(coords, step, n_sub):
        # n_sub samples per pixel spanning each pixel's full [c-h/2, c+h/2]
        return np.linspace(coords[0] - step / 2, coords[-1] + step / 2,
                           len(coords) * n_sub + 1)

    fy = fine_axis(y, dy, dNy)
    fx = fine_axis(x, dx, dNx)
    return f(fy, fx), fy, fx


def apply_2D_trapezoid_rule(y, x, f, dNy, dNx=None, dy=None, dx=None):
    """Pixel-integrate ``f`` with a subsampled trapezoid rule.

    The reference's corner weight of 0.4 (interpolation.py:695) is kept,
    as in the JAX package (an exact trapezoid rule would use 0.25).
    Ref: interpolation.py:680-705.
    """
    if dy is None:
        dy = y[1] - y[0]
    if dx is None:
        dx = x[1] - x[0]
    if dNx is None:
        dNx = dNy
    z = np.asarray(subsample_function(y, x, f, dNy, dNx, dy, dx)[0])
    # per-cell volumes, then a blocked reshape sums each pixel's cells
    cells = 0.4 * (z[:-1, :-1] + z[1:, :-1] + z[:-1, 1:] + z[1:, 1:])
    cells *= dy * dx / (dNy * dNx)
    return cells.reshape(len(y), dNy, len(x), dNx).sum(axis=(1, 3))


def get_psf_size(psf):
    """Approximate 3-sigma radius of a PSF from its FWHM area.

    Ref: interpolation.py:708-739.
    """
    psf = np.asarray(psf)
    psf_frame = psf / np.max(psf)
    area = np.sum(psf_frame > 0.5)
    d = 2 * (area / np.pi) ** 0.5
    return 3 * d / (2 * (2 * np.log(2)) ** 0.5)


def sinc2D(y, x):
    """The product of two 1D sincs, in float32: for 1D ``y`` and ``x``
    their inner product (a scalar), for 2D a matrix product, as the JAX
    package's ``jnp.dot`` gives.  Ref: interpolation.py:641-654."""
    sy = torch.sinc(torch.as_tensor(np.asarray(y), dtype=torch.float32))
    sx = torch.sinc(torch.as_tensor(np.asarray(x), dtype=torch.float32))
    return torch.matmul(sy, sx)


def interpolate_observation(observation, frame, wave_filter=False):
    """Sinc-resample an observation's images onto ``frame``'s grid (host
    numpy out, float64); with ``wave_filter`` each band is first denoised
    by :func:`~.wavelet.apply_wavelet_denoising`.  The observation's grid
    is taken square, as in the reference.  Ref: interpolation.py:563-599.
    """
    from . import wavelet as wavelet_ops

    coord_lr0 = np.array(
        (np.arange(observation.shape[1]), np.arange(observation.shape[2])))
    coord_hr = (np.arange(frame.shape[1]), np.arange(frame.shape[2]))
    coord_lr = observation.convert_pixel_to(frame, pixel=coord_lr0.T).T

    images = observation.data.detach().cpu().numpy()
    if wave_filter:
        images = np.array([wavelet_ops.apply_wavelet_denoising(image)
                           for image in images])
    return np.array([
        sinc_interp(torch.from_numpy(np.array(image[None])), coord_hr,
                    coord_lr, angle=None)[0].T.numpy()
        for image in images])
