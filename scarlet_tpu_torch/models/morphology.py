"""Morphology models: the 2D spatial factors of factorized components.
Port of ``scarlet_tpu/models/morphology.py``.

``get_model`` works on tensors (autograd flows through it); box resizing
(``update``) happens on the host between fit segments, on the numpy
copies the fit fetched (``Parameter.host``), and signals a restart with
:class:`UpdateException`, as in the reference.
Behavioral reference: scarlet/morphology.py (file:line cited per class).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bbox import Box, overlapped_slices
from ..ops import fft as fft_ops
from ..ops.special import kv
from ..ops.wavelet import Starlet, starlet_reconstruction
from .. import initialization as init
from . import constraint as _constraint
from .constraint import ConstraintChain
from .frame import Frame
from .model import Model, UpdateException
from .parameter import Parameter, prepare_param, relative_step
from .psf import PSF

__all__ = [
    "Morphology",
    "ImageMorphology",
    "ProfileMorphology",
    "GaussianMorphology",
    "SpergelMorphology",
    "PointSourceMorphology",
    "StarletMorphology",
    "ExtendedSourceMorphology",
]


class Morphology(Model):
    """Base class. Ref: scarlet/morphology.py:26-68."""

    def __init__(self, frame, *parameters, bbox=None):
        assert isinstance(frame, Frame), "frame must be a Frame"
        self.frame = frame
        bbox = frame.bbox if bbox is None else bbox
        assert isinstance(bbox, Box), "bbox must be a Box"
        self.bbox = bbox
        super().__init__(*parameters)

    def shrink_box(self, image, thresh=0):
        """Shrink the box to the smallest bucket still containing every
        above-threshold pixel, keeping the center fixed (host-side).

        The reference's border-peeling loop (morphology.py:52-68) as one
        reduction: the number of clean border rings is the smallest border
        distance of any hot pixel (capped at the half-size).
        """
        image = np.asarray(image)
        ny, nx = image.shape
        size = max(image.shape)
        hot_i, hot_j = np.nonzero(image > thresh)
        if hot_i.size:
            border = np.minimum(np.minimum(hot_i, ny - 1 - hot_i),
                                np.minimum(hot_j, nx - 1 - hot_j))
            dist = min(int(border.min()), size // 2)
        else:
            dist = size // 2
        newsize = init.get_minimal_boxsize(size - 2 * dist)
        if newsize < size:
            dist = (size - newsize) // 2
            self.bbox.origin = tuple(o + dist for o in self.bbox.origin)
            self.bbox.shape = (newsize, newsize)


def _resized(image, value, moments):
    """The image Parameter after a box resize: ``value`` and the moments
    (numpy) at the new shape, a halved float step."""
    m, v, vhat = moments
    return Parameter(
        value, name=image.name, prior=image.prior,
        constraint=image.constraint,
        step=image.step / 2 if not callable(image.step) else image.step,
        fixed=image.fixed, m=m, v=v, vhat=vhat)


class ImageMorphology(Morphology):
    """Free-form image morphology with optional Fourier sub-pixel shift and
    dynamic box resizing.  Ref: scarlet/morphology.py:71-207.
    """

    def __init__(self, frame, image, bbox=None, shifting=False, shift=None,
                 resizing=True):
        if not isinstance(image, Parameter):
            image = Parameter(image, name="image", step=relative_step,
                              constraint=_constraint.PositivityConstraint())
        assert image.name == "image", "image parameter must be named 'image'"

        if bbox is None:
            assert frame.bbox[1:].shape == image.shape, \
                "image must fill the frame when no bbox is given"
            bbox = Box(image.shape)
        assert bbox.shape == image.shape, "bbox/image shape mismatch"

        self.resizing = resizing
        self.shifting = shifting

        if shift is None:
            shift = Parameter(np.zeros(2), name="shift", step=1e-2,
                              fixed=not self.shifting)
        else:
            assert np.shape(shift) == (2,), "shift must be (dy, dx)"
            if not isinstance(shift, Parameter):
                shift = Parameter(shift, name="shift", step=1e-2)
            assert shift.name == "shift", \
                "shift parameter must be named 'shift'"

        super().__init__(frame, image, shift, bbox=bbox)

    def get_model(self, *parameters):
        image = self.get_parameter(0, *parameters)
        shift = self.get_parameter(1, *parameters)
        if self.shifting:
            image = fft_ops.shift(image, shift, return_fourier=False)
        return image

    def update(self):
        """Shrink the box when borders are empty, or grow it when the adaprox
        gradient pulls flux at the edges; raises UpdateException.
        Ref: morphology.py:132-207.
        """
        image = self._parameters[0]
        if not self.resizing or image.fixed:
            return

        img = image.host()
        bbox = self.bbox.copy()
        self.shrink_box(img)
        if bbox != self.bbox:
            slc, _ = overlapped_slices(bbox, self.bbox)
            moments = tuple(None if image.host(k) is None
                            else image.host(k)[slc]
                            for k in ("m", "v", "vhat"))
            self._parameters = (_resized(image, img[slc], moments),) \
                + self._parameters[1:]
            raise UpdateException

        if image.m is not None:
            m = image.host("m")
            v = image.host("v")
            step = image.step if not callable(image.step) else 1e-2
            with np.errstate(divide="ignore", invalid="ignore"):
                gu = np.where(v > 0, -m / np.sqrt(np.sqrt(v)) * step, 0.0)
            gu_pull = gu * (img > 0)
            edge_pull = np.array([
                gu_pull[:, 0].mean(),
                gu_pull[:, -1].mean(),
                gu_pull[0, :].mean(),
                gu_pull[-1, :].mean(),
            ])
            if np.any(edge_pull > 0.1):
                size = max(bbox.shape)
                newsize = init.get_minimal_boxsize(size + 1)
                pad_width = (newsize - size) // 2
                vhat = image.host("vhat")
                moments = (np.pad(m, pad_width), np.pad(v, pad_width),
                           None if vhat is None else np.pad(vhat, pad_width))
                self._parameters = (_resized(
                    image, np.pad(img, pad_width, mode="linear_ramp"),
                    moments),) + self._parameters[1:]
                self.bbox.origin = tuple(o - pad_width
                                         for o in self.bbox.origin)
                self.bbox.shape = (newsize, newsize)
                raise UpdateException


class ProfileMorphology(Morphology):
    """Parametric radial profile with center/radius/ellipticity parameters
    and a dynamic box.  Ref: scarlet/morphology.py:210-326.
    """

    def __init__(self, frame, func, *parameters, boxsize=None, resize=True):
        self.f = func
        self.center = self._find_param(parameters, "center")
        bbox = self.get_box(boxsize=boxsize, _params=parameters)
        self.resizing = resize
        self._set_grid(bbox)

        radius = self._find_param(parameters, "radius")
        radius.constraint = self._radius_prox
        eps = self._find_param(parameters, "ellipticity")
        eps.constraint = self._eps_prox

        super().__init__(frame, *parameters, bbox=bbox)

    def _set_grid(self, bbox):
        self._Y = torch.arange(bbox.shape[-2], dtype=torch.float64) \
            + bbox.origin[-2]
        self._X = torch.arange(bbox.shape[-1], dtype=torch.float64) \
            + bbox.origin[-1]

    @staticmethod
    def _find_param(parameters, name):
        for p in parameters:
            if p.name == name:
                return p
        return None

    def get_model(self, *parameters):
        center = self.get_parameter("center", *parameters)
        _Y = self._Y.to(center.device, center.dtype) - center[-2]
        _X = self._X.to(center.device, center.dtype) - center[-1]

        e = self.get_parameter("ellipticity", *parameters)
        if not parameters and bool(torch.all(e == 0)):
            R2 = _Y[:, None] ** 2 + _X[None, :] ** 2
        else:
            e1, e2 = e[0], e[1]
            norm = torch.sqrt(1 - (e1 ** 2 + e2 ** 2))
            __X = ((1 - e1) * _X[None, :] - e2 * _Y[:, None]) / norm
            __Y = (-e2 * _X[None, :] + (1 + e1) * _Y[:, None]) / norm
            R2 = __Y ** 2 + __X ** 2

        Rp = self.get_parameter("radius", *parameters)
        R2 = R2 / Rp ** 2
        return self.f(R2, *parameters)

    @property
    def integral(self):
        raise NotImplementedError

    def update(self):
        """Re-derive the box from the current radius; raise on change.
        Ref: morphology.py:288-300."""
        if not self.resizing:
            return
        bbox = self.get_box()
        if bbox != self.bbox:
            self.bbox.origin = bbox.origin
            self.bbox.shape = bbox.shape
            self._set_grid(bbox)
            raise UpdateException

    def get_box(self, boxsize=None, _params=None):
        """The box of ``boxsize`` (default: the bucket of 10 radii)
        centered on the rounded center (host values)."""
        params = self.parameters if _params is None else _params

        def get(name):
            return self._find_param(params, name).host()

        if boxsize is None:
            size = float(10 * np.max(get("radius")))
            boxsize = init.get_minimal_boxsize(size)
        shape = (boxsize, boxsize)
        center = get("center")
        origin = (
            int(round(float(center[-2]))) - (boxsize // 2),
            int(round(float(center[-1]))) - (boxsize // 2),
        )
        return Box(shape, origin=origin)

    def _radius_prox(self, x, step):
        return torch.clamp_min(x, 1e-2)

    def _eps_prox(self, x, step):
        norm2 = torch.sum(x ** 2)
        return torch.where(norm2 > 1, x / (torch.sqrt(norm2) * 1.1), x)


class GaussianMorphology(ProfileMorphology):
    """Gaussian radial profile. Ref: scarlet/morphology.py:329-369."""

    def __init__(self, frame, center, sigma, ellipticity=(0, 0),
                 boxsize=None):
        assert len(center) == 2
        self.center = prepare_param(center, name="center")
        radius = prepare_param(sigma, name="radius")
        assert ellipticity is None or len(ellipticity) == 2
        if ellipticity is None:
            ellipticity = (0, 0)
        ellipticity = prepare_param(ellipticity, name="ellipticity")
        parameters = (self.center, radius, ellipticity)

        if boxsize is None:
            boxsize = int(np.ceil(10 * np.max(np.asarray(sigma))))

        super().__init__(frame, self._f, *parameters, boxsize=boxsize)

    def _f(self, R2, *parameters):
        return torch.exp(-R2 / 2)

    @property
    def integral(self):
        radius = self.get_parameter("radius")
        return 2 * np.pi * radius ** 2


class SpergelMorphology(ProfileMorphology):
    """Spergel (2010) Bessel-K profile; ``kv`` by quadrature on the
    tensors' device (ops/special.py).  Ref: scarlet/morphology.py:384-473.
    """

    def __init__(self, frame, center, nu, rhalf, ellipticity=(0, 0),
                 boxsize=None):
        assert len(center) == 2
        self.center = prepare_param(center, name="center")

        self._minimum_nu = -0.85
        self._maximum_nu = 4.00
        nu = prepare_param(nu, name="nu")
        assert self._minimum_nu <= float(nu.host()[0]) <= self._maximum_nu
        nu.constraint = self._nu_prox

        radius = prepare_param(rhalf, name="radius")
        assert ellipticity is None or len(ellipticity) == 2
        if ellipticity is None:
            ellipticity = (0, 0)
        ellipticity = prepare_param(ellipticity, name="ellipticity")
        parameters = (self.center, nu, radius, ellipticity)

        if boxsize is None:
            boxsize = int(np.ceil(10 * np.max(np.asarray(rhalf))))

        # 4th-order polynomial fit of c_nu (Spergel 2010 Table 1)
        self._z = (-0.00788962, 0.0735303, -0.27770785, 0.99483285,
                   1.25227402)
        super().__init__(frame, self._f, *parameters, boxsize=boxsize)

    def _f(self, R2, *parameters):
        nu = self.get_parameter("nu", *parameters)[0]
        cnu = self._cnu(nu)
        x = torch.sqrt(R2 + 1e-4) * cnu
        return self._f_nu(x, nu)

    @property
    def integral(self):
        radius = self.get_parameter("radius")
        nu = self.get_parameter("nu")[0]
        cnu = self._cnu(nu)
        return 2 * np.pi * radius ** 2 / cnu ** 2

    def _f_nu(self, x, nu):
        # Eqn 3 in Spergel (2010)
        return (x / 2) ** nu * kv(nu, x) / torch.exp(torch.lgamma(nu + 1))

    def _cnu(self, nu):
        z = self._z
        return (z[0] * nu ** 4 + z[1] * nu ** 3 + z[2] * nu ** 2
                + z[3] * nu + z[4])

    def _nu_prox(self, x, step):
        return torch.clamp(x, self._minimum_nu, self._maximum_nu)


class PointSourceMorphology(Morphology):
    """The frame PSF evaluated at a (possibly fractional) center.
    Ref: scarlet/morphology.py:476-513.
    """

    def __init__(self, frame, center):
        assert frame.psf is not None and isinstance(frame.psf, PSF)
        self.psf = frame.psf

        pixel_center = tuple(np.round(np.asarray(center)).astype(int))
        shift = (0, *pixel_center)
        bbox = self.psf.bbox + shift

        self.center = prepare_param(center, name="center")
        super().__init__(frame, self.center, bbox=bbox)

    def get_model(self, *parameters):
        center = self.get_parameter(0, *parameters)
        box_center = np.mean(np.asarray(self.bbox.bounds[1:], float),
                             axis=1)
        offset = center - torch.as_tensor(box_center, dtype=center.dtype,
                                          device=center.device)
        return self.psf.get_model(offset=offset)

    @property
    def integral(self):
        return self.psf.get_model().sum()


class StarletMorphology(Morphology):
    """Starlet coefficients as an overcomplete non-parametric model; the
    forward model is their reconstruction (plain torch, differentiated by
    autograd).  Ref: scarlet/morphology.py:516-604,
    scarlet_tpu/models/morphology.py:398-470.

    The constraint is positivity then hard thresholding at ``threshold``
    times the transform's norm per scale (0 on the coarse plane), or with
    ``monotonic`` the host mask projection of every plane.  The
    thresholds are held per scale, (J + 1, 1, 1), and broadcast over the
    box: the JAX package holds a (J + 1, H, W) array of the same values,
    which keeps the first box's shape when ``update`` shrinks the box, so
    its next prox raises; here they follow any box.
    """

    def __init__(self, frame, image, bbox=None, monotonic=False, threshold=0):
        if bbox is None:
            assert frame.bbox[1:].shape == image.shape, \
                "image must fill the frame when no bbox is given"
            bbox = Box(image.shape)
        self.monotonic = monotonic
        self.transform = Starlet.from_image(image)
        coeffs = self.transform.coefficients.numpy()

        if not self.monotonic:
            thresh = threshold * self.transform.norm.numpy()
            thresh[-1] = 0
            constraint = ConstraintChain(
                _constraint.PositivityConstraint(0),
                _constraint.L0Constraint(thresh[:, None, None]))
        else:
            constraint = self._mask_constraint(bbox)

        coeffs = Parameter(coeffs, name="coeffs", step=1e-2,
                           constraint=constraint)
        super().__init__(frame, coeffs, bbox=bbox)

    @staticmethod
    def _mask_constraint(bbox):
        center = tuple(s // 2 for s in bbox.shape)
        return _constraint.MonotonicMaskConstraint(center, center_radius=1)

    def get_model(self, *parameters):
        coeffs = self.get_parameter(0, *parameters)
        return starlet_reconstruction(coeffs)

    def update(self):
        """Shrink the box when the reconstruction's borders are empty
        (below 1e-8), carrying the coefficients and the moments over,
        sliced; raises UpdateException.  The reconstruction is computed
        on the host from the coefficients' host copy (the values the fit
        fetched), the same shift-adds in the same precision as on the
        device.  Ref: morphology.py:572-604."""
        coeffs = self._parameters[0]
        if coeffs.fixed:
            return
        c = coeffs.host()
        image = starlet_reconstruction(torch.from_numpy(c)).numpy()
        bbox = self.bbox.copy()
        self.shrink_box(image, thresh=1e-8)
        if bbox != self.bbox:
            slc, _ = overlapped_slices(bbox, self.bbox)
            slc = (slice(None),) + tuple(slc)
            constraint = self._mask_constraint(self.bbox) \
                if self.monotonic else coeffs.constraint
            moments = {k: None if coeffs.host(k) is None
                       else coeffs.host(k)[slc] for k in ("m", "v", "vhat")}
            new_coeffs = Parameter(
                c[slc], name=coeffs.name, prior=coeffs.prior,
                constraint=constraint, step=coeffs.step, fixed=coeffs.fixed,
                **moments)
            self._parameters = (new_coeffs,) + self._parameters[1:]
            raise UpdateException


class ExtendedSourceMorphology(ImageMorphology):
    """Image morphology with the extended-source constraint chain
    (monotonicity [+symmetry] + positivity + center-on + max-normalization).
    Ref: scarlet/morphology.py:607-688.
    """

    def __init__(self, frame, center, image, bbox=None, monotonic="angle",
                 symmetric=False, min_grad=0, shifting=False, resizing=True):
        # the reference's chain order is load-bearing (positivity AFTER the
        # monotonic/symmetric projections, max-norm last)
        monotonic = {True: "angle", False: None}.get(monotonic, monotonic)
        chain = ([_constraint.MonotonicityConstraint(
            neighbor_weight=monotonic, min_gradient=min_grad)]
            if monotonic is not None else [])
        if symmetric:
            chain.append(_constraint.SymmetryConstraint())
        chain.extend((_constraint.PositivityConstraint(),
                      _constraint.CenterOnConstraint(),
                      _constraint.NormalizationConstraint("max")))
        morph_constraint = ConstraintChain(*chain)
        image = Parameter(image, name="image", step=1e-2,
                          constraint=morph_constraint)

        self.pixel_center = np.round(np.asarray(center)).astype(int)
        if shifting:
            shift = Parameter(np.asarray(center) - self.pixel_center,
                              name="shift", step=1e-1)
        else:
            shift = None
        self.shift = shift

        super().__init__(frame, image, bbox=bbox, shifting=shifting,
                         shift=shift, resizing=resizing)

    @property
    def center(self):
        if self.shift is not None:
            return self.pixel_center + self.shift.host()
        return self.pixel_center
