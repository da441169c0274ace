"""Renderers: parameterized transformations from the model frame into an
observation's frame.  Port of ``scarlet_tpu/models/renderer.py``.

The host precomputes each renderer's tensors once, in float64 (difference
kernel and its transform), and keeps them on the observation's device in
the model frame's precision.  A transform
takes a model of shape (C, H, W), or a batch (..., C, H, W) of models,
and autograd flows through it.

``ResolutionRenderer`` (multi-resolution sinc resampling) lives in
:mod:`scarlet_tpu_torch.models.resolution`.

Behavioral reference: scarlet/renderer.py.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..bbox import Box, overlapped_slices
from ..lite.engine import pin_float32
from ..ops import fft as fft_ops
from ..ops import interpolation
from .model import Model
from .parameter import Parameter

__all__ = ["Renderer", "NullRenderer", "ConvolutionRenderer", "convolve",
           "match_shape"]


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def complex_dtype(dtype):
    """The complex torch dtype of a real one's precision."""
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def convolve(image, kernel, bounds=None):
    """Real-space per-channel convolution of (..., C, H, W) ``image`` with
    the odd (C, kh, kw) ``kernel``, "same" size: a grouped ``F.conv2d``
    (cross-correlation) with the flipped kernel.  ``bounds`` is accepted
    for API parity and unused.  Ref: renderer.py:97-127 (the JAX package's
    depthwise ``conv_general_dilated``)."""
    kernel = torch.as_tensor(kernel, device=image.device)
    C, H, W = image.shape[-3:]
    kh, kw = kernel.shape[-2:]
    assert kh % 2 == 1 and kw % 2 == 1, "kernel must be odd-sized"
    k = torch.flip(kernel, (-2, -1))
    out = F.conv2d(image.reshape(-1, C, H, W).to(k.dtype), k[:, None],
                   padding="same", groups=C)
    return out.reshape(*image.shape[:-3], C, H, W)


def match_shape(model, data_frame, slices):
    """Slice or zero-pad a rendered (..., C, H, W) model to the data
    frame's spatial shape.  Ref: scarlet/renderer.py:130-161."""
    data_slices, model_slices = slices
    data_shape = data_frame.shape
    sliced = model[(Ellipsis, *model_slices)]
    if any(
        data_slices[d].stop - data_slices[d].start != data_shape[d]
        for d in range(-2, 0)
    ):
        matched = model.new_zeros(model.shape[:-3] + tuple(data_shape))
        matched[(Ellipsis, *data_slices)] = sliced
        return matched
    return sliced


class Renderer(Model):
    """Base renderer: channel mapping + a parameterized transform.  Its
    precomputed tensors live on the data frame's device, where its
    products run in full float32 (TF32 off).
    Ref: scarlet/renderer.py:12-83."""

    def __init__(self, data_frame, model_frame, *parameters):
        self.data_frame = data_frame
        self.model_frame = model_frame
        self.device = getattr(data_frame, "device", torch.device("cpu"))
        pin_float32(self.device)
        self.channel_map = self.get_channel_map(data_frame, model_frame)
        super().__init__(*parameters)

    def __call__(self, model, *parameters):
        self.transform = self.get_model(*parameters)
        return self.transform(model)

    def get_channel_map(self, data_frame, model_frame):
        """None (identical), slice (contiguous subset), or index list.
        Ref: renderer.py:26-64."""
        if list(data_frame.channels) == list(model_frame.channels):
            return None
        channel_map = [
            list(model_frame.channels).index(c)
            for c in list(data_frame.channels)
        ]
        min_channel = min(channel_map)
        max_channel = max(channel_map)
        if max_channel + 1 - min_channel == len(channel_map):
            channel_map = slice(min_channel, max_channel + 1)
        return channel_map

    def map_channels(self, model):
        """Restrict or mix the model channels (axis -3) onto the
        observation's.  A mixing matrix (C_obs, C_model) contracts the
        channel axis.  Ref: renderer.py:66-83 (whose ``np.dot`` of a
        matrix and a (C, H, W) cube contracts the row axis instead)."""
        cmap = self.channel_map
        if cmap is None:
            return model
        if isinstance(cmap, (slice, list)):
            return model[..., cmap, :, :]
        mix = torch.as_tensor(np.asarray(cmap), dtype=model.dtype,
                              device=model.device)
        return torch.einsum("oc,...chw->...ohw", mix, model)


class NullRenderer(Renderer):
    """Identity transform (observation in the model frame already).
    Ref: renderer.py:86-94."""

    def __init__(self, data_frame, model_frame):
        super().__init__(data_frame, model_frame)

    def get_model(self, *parameters):
        def nothing(model):
            return model
        return nothing


class ConvolutionRenderer(Renderer):
    """Same-grid rendering: channel map -> difference-kernel convolution ->
    spatial shape matching.  Ref: scarlet/renderer.py:164-259."""

    def __init__(self, data_frame, model_frame, *parameters,
                 convolution_type="fft", padding=10, psf_shift=None):
        if psf_shift is not None:
            psf_shift = Parameter(psf_shift, name="psf_shift", step=1.0e-2)
            parameters = (*parameters, psf_shift)

        super().__init__(data_frame, model_frame, *parameters)

        assert convolution_type in ("real", "fft"), \
            "`convolution` must be either 'real' or 'fft'"
        self._convolution_type = convolution_type

        # 2D region covered by data inside the model frame (translation
        # only, ref renderer.py:187-192).  The box extent is exactly the
        # data frame's spatial shape: deriving it from round(max)+1 (as the
        # reference does) is fragile under the ~1e-13 noise of the WCS
        # round trip when grids sit at half-pixel offsets.
        pixel_in_model_frame = data_frame.convert_pixel_to(model_frame)
        mins = pixel_in_model_frame.min(axis=0)
        ll = np.round(mins).astype(int)
        ur = ll + np.asarray(data_frame.shape[-2:], int)
        bounds = (ll[0], ur[0]), (ll[1], ur[1])
        data_box = model_frame.bbox[0] @ Box.from_bounds(*bounds)
        self.slices = overlapped_slices(data_box, model_frame.bbox)

        # the difference kernel and its transform in float64 on the host,
        # from the PSFs in the model's dtype (as the JAX package rounds
        # them); the device keeps them in the model's precision
        dtype = torch_dtype(model_frame.dtype)
        psf = data_frame.psf.get_model().to(dtype).double()
        model_psf = model_frame.psf.get_model().to(dtype).double()
        self.diff_kernel = fft_ops.match_psf(
            fft_ops.Fourier(psf), fft_ops.Fourier(model_psf), padding=padding)

        # Same-scale grids can still sit at a fractional pixel offset (e.g.
        # concentric even- and odd-sized frames are exactly half a pixel
        # apart).  Fold the subpixel residual into the difference kernel as
        # a one-time Fourier shift so the sliced render lands on the data
        # grid (the reference's integer-only slicing loses this,
        # renderer.py:190).
        frac = mins - ll
        if np.any(np.abs(frac) > 1e-6):
            shifted = fft_ops.shift(
                self.diff_kernel.image,
                torch.as_tensor(-frac.astype(model_frame.dtype)),
                axes=(-2, -1), return_fourier=False)
            self.diff_kernel = fft_ops.Fourier(shifted)

        # the kernel's transform for the model-shaped hot path
        self._model_shape = tuple(model_frame.shape)
        self._fft_shape = fft_ops.minimal_even_fft_shape(
            self._model_shape, self.diff_kernel.shape, axes=(-2, -1))
        self._kernel_rfft = fft_ops.transform(
            self.diff_kernel.image, self._fft_shape, (-2, -1)).to(
                self.device, complex_dtype(dtype))
        self._kernel = self.diff_kernel.image.to(self.device, dtype)

    @property
    def convolution_bounds(self):
        """Filter clip bounds of the difference kernel's first channel (API
        parity; no convolution path reads them): the float64 host kernel
        through ``interpolation.get_filter_coords`` and
        ``get_filter_bounds``."""
        if not hasattr(self, "_convolution_bounds"):
            coords = interpolation.get_filter_coords(
                self.diff_kernel.image[0].cpu().numpy())
            self._convolution_bounds = interpolation.get_filter_bounds(
                coords.reshape(-1, 2))
        return self._convolution_bounds

    def convolve(self, model, convolution_type=None, psf_shift=None):
        """Convolve the (channel-mapped) model with the difference kernel.
        Ref: renderer.py:215-241."""
        if convolution_type is None:
            convolution_type = self._convolution_type

        if psf_shift is not None:
            kernel = fft_ops.shift(
                self._kernel, psf_shift, fft_shape=None, axes=(-2, -1),
                return_fourier=False).to(model.dtype)
        else:
            kernel = None  # use the precomputed transform

        if convolution_type == "real":
            return convolve(model, self._kernel if kernel is None else kernel)
        if convolution_type == "fft":
            # the difference kernel lives in observation channel space, so
            # it applies directly to the channel-mapped model
            if kernel is None and model.shape[-2:] == self._model_shape[-2:]:
                return fft_ops.convolve_fft(
                    model, self._kernel_rfft, self._fft_shape, (-2, -1))
            k = self._kernel if kernel is None else kernel
            # unit leading dims, so that the kernel broadcasts over a batch
            k = k.reshape((1,) * (model.ndim - k.ndim) + tuple(k.shape))
            return fft_ops.convolve(
                fft_ops.Fourier(model), fft_ops.Fourier(k), axes=(-2, -1),
                return_fourier=False)
        raise ValueError(
            f"`convolution` must be 'real' or 'fft', got {convolution_type}")

    def __call__(self, model, *parameters):
        self.transform = self.get_model(*parameters)
        return self.transform(model, *parameters)

    def get_model(self, *parameters):
        def transform(model, *parameters):
            model_ = self.map_channels(model)
            shift = self.get_parameter("psf_shift", *parameters)
            model_ = self.convolve(model_, psf_shift=shift)
            return match_shape(model_, self.data_frame, self.slices)
        return transform
