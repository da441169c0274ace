"""Observation: data + weights + renderer selection + likelihood.  Port of
``scarlet_tpu/models/observation.py``; data and weights are tensors on the
observation's device (the CUDA card unless the caller asks otherwise).

Behavioral reference: scarlet/observation.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bbox import overlapped_slices
from ..device import default_device
from ..ops import interpolation
from .frame import Frame
from .renderer import ConvolutionRenderer, NullRenderer, Renderer, torch_dtype

__all__ = ["Observation"]


class Observation(Frame):
    """A single multiband observation: (C, Ny, Nx) data cube with inverse
    variance weights, on ``device`` (default: the device of ``data`` if it
    is a tensor, else the CUDA card).  Ref: scarlet/observation.py:9-57.
    """

    def __init__(self, data, channels, psf=None, weights=None, wcs=None,
                 padding=10, device=None):
        device = default_device(device, like=data)
        data = torch.as_tensor(data, device=device)
        super().__init__(tuple(data.shape), wcs=wcs, psf=psf,
                         channels=channels,
                         dtype=torch.empty(0, dtype=data.dtype).numpy().dtype)
        self.data = data
        if weights is not None:
            self.weights = torch.as_tensor(weights, device=device)
        else:
            self.weights = torch.ones_like(data)
        assert self.weights.shape == self.data.shape, \
            "Weights needs to have same shape as data"
        self.padding = padding

    @property
    def device(self):
        return self.data.device

    def match(self, model_frame, renderer=None):
        """Select and configure the renderer mapping the model frame onto
        this observation.  Ref: observation.py:59-114.
        """
        self.model_frame = model_frame

        if self.dtype != model_frame.dtype:
            self.dtype = model_frame.dtype
            self.data = self.data.to(torch_dtype(model_frame.dtype))
            self.weights = self.weights.to(torch_dtype(model_frame.dtype))

        if renderer is None:
            if self.psf is model_frame.psf:
                self.renderer = NullRenderer(self, model_frame)
            else:
                assert self.psf is not None and model_frame.psf is not None
                if self.wcs is model_frame.wcs:
                    self.renderer = ConvolutionRenderer(
                        self, model_frame, convolution_type="fft")
                else:
                    assert self.wcs is not None and \
                        model_frame.wcs is not None
                    angle, h = interpolation.get_angles(self.wcs,
                                                        model_frame.wcs)
                    same_res = abs(h - 1) < np.finfo(float).eps
                    same_rot = (np.abs(angle[1]) ** 2) < np.finfo(float).eps
                    if same_res and same_rot:
                        self.renderer = ConvolutionRenderer(
                            self, model_frame, convolution_type="fft")
                    else:
                        from .resolution import ResolutionRenderer

                        self.renderer = ResolutionRenderer(self, model_frame)
        else:
            assert isinstance(renderer, Renderer)
            self.renderer = renderer
        return self

    @property
    def noise_rms(self):
        """Per-pixel noise RMS (host numpy); zero-weight (masked) pixels get
        inf.  Ref: observation.py:116-124."""
        if not hasattr(self, "_noise_rms"):
            w = self.weights.cpu().numpy()
            with np.errstate(divide="ignore"):
                rms = np.where(w > 0, 1.0 / np.sqrt(np.where(w > 0, w, 1.0)),
                               np.inf)
            self._noise_rms = rms
        return self._noise_rms

    @property
    def parameters(self):
        return self.renderer.parameters

    def render(self, model, *parameters):
        """Map a model-frame cube (or a batch of them) into this
        observation.  Ref: obs.py:131-145."""
        return self.renderer(model, *parameters)

    def get_log_likelihood(self, model, *parameters, noise_factor=0):
        """Gaussian logL of the rendered model. Ref: observation.py:147-170."""
        model_ = self.render(model, *parameters)
        data_ = self.data
        weights_ = self.weights
        if noise_factor > 0:
            rms = np.where(np.isfinite(self.noise_rms), self.noise_rms, 0.0)
            noise = np.random.normal(loc=0, scale=rms)
            data_ = data_ + torch.as_tensor(noise, dtype=data_.dtype,
                                            device=data_.device)
            weights_ = weights_ / (noise_factor + 1)
        return -self.log_norm - torch.sum(weights_ * (model_ - data_) ** 2) / 2

    @property
    def log_norm(self):
        """Gaussian normalization constant over unmasked pixels.
        Ref: observation.py:172-186."""
        if not hasattr(self, "_log_norm"):
            rms = self.noise_rms
            finite = np.isfinite(rms)
            D = finite.sum()
            log_norm = D / 2 * np.log(2 * np.pi)
            log_norm += np.log(rms[finite]).sum()
            self._log_norm = float(log_norm)
        return self._log_norm

    def _to_frame(self, frame, data=None):
        """Project this observation into another same-grid frame (host
        numpy).  Ref: observation.py:188-207."""
        frame_slices, observation_slices = overlapped_slices(frame.bbox,
                                                             self.bbox)
        if data is None:
            data = self.data
        if isinstance(data, torch.Tensor):
            data = data.cpu().numpy()
        dtype = frame.dtype if hasattr(frame, "dtype") else data.dtype
        result = np.zeros(frame.shape, dtype=dtype)
        result[frame_slices] = np.asarray(data)[observation_slices]
        return result
