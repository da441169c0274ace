"""Multi-resolution rendering: map the model frame onto an observation with
a different pixel scale and/or rotation by band-limited (sinc) resampling.
Port of ``scarlet_tpu/models/resolution.py``.

The low-resolution image is the PSF-difference-convolved model evaluated
at the LR pixel positions by sinc interpolation, scaled by the pixel-area
ratio h^2.  The host precomputes each form's operators once per
instrument pair in float64 (the difference kernel, the sinc matrices, the
shifted kernel stack) and keeps them on the observation's device in the
model frame's precision (float32, complex64 phasors, for the fitter):

* aligned grids: one FFT convolution of the model with the difference
  kernel, then two dense sinc-sampling products
  ``LR = h^2 * P_y (model (*) K) P_x^T``;
* rotated grids: the LR position of pixel (i, j) decomposes affinely as
  ``p_ij = s_i + o_j + t``; a stack of kernel images Fourier-shifted to
  ``s_i + t`` is precomputed, the model is shifted by ``-o_j`` at render
  time, and ``LR[c, i, j] = h^2 <A_i, B_j>``: one product per channel
  over the padded grid.  Both A and B are taken in FFT order (the JAX
  package rolls both by fftshift; the inner product is the same).

Every product runs in float32 with TF32 off (the base ``Renderer`` turns
it off on the card):
on the TPU a lower matmul tier cost 11 dB of SDR on the rotated render
(BASELINE.md:440-455).

Behavioral reference: scarlet/renderer.py:262-547 (ResolutionRenderer).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import fft as fft_ops
from ..ops import interpolation
from .renderer import Renderer, complex_dtype, torch_dtype

__all__ = ["ResolutionRenderer"]


class ResolutionRenderer(Renderer):
    """Render a model frame into an observation at a different resolution
    and/or orientation.  Ref: scarlet/renderer.py:262-547."""

    def __init__(self, data_frame, model_frame, padding=10):
        super().__init__(data_frame, model_frame)

        self.angle, self.h = interpolation.get_angles(data_frame.wcs,
                                                      model_frame.wcs)
        self.isrot = (np.abs(self.angle[1]) ** 2) > np.finfo(float).eps

        dtype = torch_dtype(model_frame.dtype)
        dev = self.device
        # the difference kernel at model resolution, float64 (ref: 365-412)
        self._diff_kernel = self._build_diffkernel(data_frame, model_frame)

        # LR pixel positions in the model frame, affine decomposition
        C_obs = data_frame.C
        Ny_lr, Nx_lr = data_frame.shape[-2:]
        H, W = model_frame.shape[-2:]

        rows = np.stack([np.arange(Ny_lr), np.zeros(Ny_lr)], axis=1)
        cols = np.stack([np.zeros(Nx_lr), np.arange(Nx_lr)], axis=1)
        origin = np.atleast_2d(
            data_frame.convert_pixel_to(model_frame, pixel=np.array([[0., 0.]]))
        )[0]
        pos_rows = np.atleast_2d(
            data_frame.convert_pixel_to(model_frame, pixel=rows))
        pos_cols = np.atleast_2d(
            data_frame.convert_pixel_to(model_frame, pixel=cols))
        s = pos_rows - origin[None, :]     # (Ny_lr, 2): row direction steps
        o = pos_cols - origin[None, :]     # (Nx_lr, 2): column direction steps

        self._model_shape = tuple(model_frame.shape)

        if not self.isrot:
            # aligned: rows move only in y, columns only in x; plain sinc
            # sampling (anti-aliasing comes from the difference kernel,
            # which contains the wide LR PSF)
            Y = s[:, 0] + origin[0]        # (Ny_lr,) y positions
            X = o[:, 1] + origin[1]        # (Nx_lr,) x positions
            yy = np.arange(H)
            xx = np.arange(W)
            self._P_y = torch.as_tensor(
                np.sinc(Y[:, None] - yy[None, :]), dtype=dtype, device=dev)
            self._P_x = torch.as_tensor(
                np.sinc(X[:, None] - xx[None, :]), dtype=dtype, device=dev)
            self._fft_shape = fft_ops.good_fft_shape_even(
                self._model_shape, tuple(self._diff_kernel.shape),
                padding=3, axes=(-2, -1))
            self._kernel_rfft = fft_ops.transform(
                self._diff_kernel, self._fft_shape, (-2, -1)).to(
                    dev, complex_dtype(dtype))
        else:
            # rotated: kernel images shifted to s_i + origin on a grid
            # padded against circular wrap of the model shifts
            self._fft_shape = fft_ops.good_fft_shape_even(
                self._model_shape, self._model_shape, padding=padding,
                axes=(-2, -1))
            fh, fw = self._fft_shape
            c0 = (fh // 2, fw // 2)

            # the flipped kernel in the fft grid (we evaluate
            # K(p - u) = K_flip(u - p))
            k_flip = torch.flip(self._diff_kernel, (-2, -1))
            shifter_y, shifter_x = fft_ops.mk_shifter(self._fft_shape)
            k_fft = fft_ops.transform(k_flip, self._fft_shape, (-2, -1))

            # delta: where model pixel (0, 0) lands in the zero-padded fft
            # grid (zero_pad's left pad), so kernel positions line up with
            # the shifted model embedding
            delta = np.array([(fh - H + 1) // 2, (fw - W + 1) // 2])
            shifts_i = torch.from_numpy(
                s + origin[None, :] - np.array(c0)[None, :] + delta[None, :])
            A_fft = k_fft[None] * self._phasors(
                shifter_y, shifter_x, shifts_i)[:, None]
            A = torch.fft.irfftn(A_fft, s=self._fft_shape, dim=(-2, -1))
            # (C, Ny_lr, V) in FFT order
            self._A = A.reshape(Ny_lr, C_obs, -1).transpose(0, 1).to(
                dev, dtype).contiguous()
            # the model shifts -o_j, from o in the model's dtype (as the JAX
            # package holds them); phasors built in complex128
            o32 = torch.from_numpy(o.astype(model_frame.dtype)).double()
            self._phase_j = self._phasors(shifter_y, shifter_x, -o32).to(
                dev, complex_dtype(dtype))

        self._Ny_lr, self._Nx_lr = Ny_lr, Nx_lr

    @staticmethod
    def _phasors(shifter_y, shifter_x, shifts):
        """(N, fh, fw//2+1) Fourier phasors of N (dy, dx) shifts."""
        return (torch.exp(shifter_y[None, :, None] * shifts[:, 0, None, None])
                * torch.exp(shifter_x[None, None, :]
                            * shifts[:, 1, None, None]))

    def _build_diffkernel(self, data_frame, model_frame):
        """Difference kernel, float64: the sinc-upsampled observation PSF
        deconvolved by the model PSF, at model resolution.
        Ref: renderer.py:365-412."""
        psf_hr = model_frame.psf.get_model().double()
        psf_lr = data_frame.psf.get_model().to(torch_dtype(model_frame.dtype))

        pad_shape = (
            np.array(
                (np.array(data_frame.shape[-2:])
                 + np.array(psf_lr.shape[-2:])) / 2
            ).astype(int) * 2 + 1
        )
        h_lr = interpolation.get_pixel_size(
            interpolation.get_affine(data_frame.wcs))
        h_hr = interpolation.get_pixel_size(
            interpolation.get_affine(model_frame.wcs))
        angle, _ = interpolation.get_angles(model_frame.wcs, data_frame.wcs)
        psf_lr_hr = interpolation.sinc_interp_inplace(
            psf_lr, h_lr, h_hr, angle, pad_shape=tuple(pad_shape))

        psf_hr = psf_hr / psf_hr.sum()
        psf_lr_hr = psf_lr_hr / psf_lr_hr.sum(dim=(-2, -1), keepdim=True)

        return fft_ops.match_psf(
            fft_ops.Fourier(psf_lr_hr), fft_ops.Fourier(psf_hr),
            return_fourier=False)

    def get_model(self, *parameters):
        def transform(model):
            model_ = self.map_channels(model)

            if not self.isrot:
                conv = fft_ops.convolve_fft(
                    model_, self._kernel_rfft, self._fft_shape, (-2, -1))
                # (Ny_lr, H) @ (..., C, H, W) @ (W, Nx_lr)
                out = self._P_y @ conv @ self._P_x.T
                return out * self.h ** 2

            # rotated: shift the model by -o_j, contract with the kernel
            # stack: (C, Ny_lr, V) @ (..., C, V, Nx_lr)
            m_fft = fft_ops.transform(model_, self._fft_shape, (-2, -1))
            B_fft = m_fft[..., None, :, :] * self._phase_j
            B = torch.fft.irfftn(B_fft, s=self._fft_shape, dim=(-2, -1))
            out = self._A @ B.flatten(-2).transpose(-2, -1)
            return out * self.h ** 2

        return transform
