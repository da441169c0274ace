"""Starlet (isotropic undecimated) wavelet transforms, batched over
leading axes.  Port of ``scarlet_tpu/ops/wavelet.py``: the transforms
(both generations, one image or a stack of bands) and their
reconstructions, the :class:`Starlet` class, the multiresolution
support (the device form that detection and the wavelet initialization
run, and the host ground and space forms) and the iterative wavelet
denoiser.

The a-trous B3-spline convolution is five zero-boundary shift-adds per
axis, in the JAX package's order, so each coefficient is the same sum of
the same products on every device, and the reconstruction (the forward
model of ``StarletMorphology``) differentiates through torch autograd.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "Starlet",
    "shift_axis",
    "bspline_convolve",
    "get_scales",
    "starlet_transform",
    "multiband_starlet_transform",
    "starlet_reconstruction",
    "multiband_starlet_reconstruction",
    "multiresolution_support",
    "get_multiresolution_support",
    "apply_wavelet_denoising",
]

# B3 spline filter (Starck et al. 2011; scarlet/wavelet.py:171)
_H1D = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def shift_axis(x, k, axis):
    """``out[i] = x[i - k]`` along ``axis`` (toward larger indices for
    ``k > 0``), zero-filled; integer ``k``.  Port of
    ``scarlet_tpu/ops/arrays.shift_axis``."""
    if k == 0:
        return x
    n = x.shape[axis]
    if abs(k) >= n:
        return torch.zeros_like(x)
    zshape = list(x.shape)
    zshape[axis] = abs(k)
    zeros = x.new_zeros(zshape)
    if k > 0:
        return torch.cat([zeros, x.narrow(axis, 0, n - k)], dim=axis)
    return torch.cat([x.narrow(axis, -k, n + k), zeros], dim=axis)


def bspline_convolve(image, scale):
    """Separable a-trous B3-spline convolution of ``image`` (..., H, W) at
    ``scale`` (tap spacing ``2**scale``), zero boundary
    (scarlet_tpu/ops/wavelet.py:36-55)."""
    j = int(scale)
    s1, s2 = 2 ** j, 2 ** (j + 1)
    h0, h1, h2, h3, h4 = _H1D

    col = image * h2
    col = col + shift_axis(image, s2, -2) * h0
    col = col + shift_axis(image, s1, -2) * h1
    col = col + shift_axis(image, -s1, -2) * h3
    col = col + shift_axis(image, -s2, -2) * h4

    result = col * h2
    result = result + shift_axis(col, s2, -1) * h0
    result = result + shift_axis(col, s1, -1) * h1
    result = result + shift_axis(col, -s1, -1) * h3
    result = result + shift_axis(col, -s2, -1) * h4
    return result


def get_scales(image_shape, scales=None):
    """Default and maximum number of starlet scales for an image of
    ``image_shape`` (scarlet_tpu/ops/wavelet.py:58)."""
    max_scale = int(np.log2(np.min(image_shape[-2:]))) - 1
    if scales is None or scales > max_scale:
        scales = max_scale
    return int(scales)


def starlet_transform(image, scales=None, generation=2, convolve2D=None):
    """Starlet coefficients of ``image`` (..., H, W): (..., scales + 1, H,
    W), the last plane the coarse residual; ``generation`` 1 or 2, and
    ``convolve2D(c, j)`` in place of the B3-spline convolution
    (scarlet_tpu/ops/wavelet.py:66-88).  The JAX function takes one 2D
    image; here leading axes are batched."""
    assert generation in (1, 2), \
        f"generation should be 1 or 2, got {generation}"
    scales = get_scales(image.shape, scales)
    if convolve2D is None:
        convolve2D = bspline_convolve
    c = image
    coeffs = []
    for j in range(scales):
        gen1 = convolve2D(c, j)
        if generation == 2:
            coeffs.append(c - convolve2D(gen1, j))
        else:
            coeffs.append(c - gen1)
        c = gen1
    coeffs.append(c)
    return torch.stack(coeffs, dim=-3)


def multiband_starlet_transform(image, scales=None, generation=2,
                                convolve2D=None):
    """(scales + 1, B, H, W) coefficients of a (B, H, W) cube, each band
    transformed alone (scarlet_tpu/ops/wavelet.py:91-103)."""
    assert image.ndim == 3, \
        f"Image should be 3D (bands, Ny, Nx), got {image.shape}"
    return starlet_transform(image, scales, generation,
                             convolve2D).transpose(0, 1)


def starlet_reconstruction(starlets, generation=2, convolve2D=None):
    """The image of starlet coefficients (..., J + 1, H, W): their sum
    (generation 1), or the coarse plane convolved back up through the
    scales (generation 2) (scarlet_tpu/ops/wavelet.py:106-117).  Plain
    torch, so autograd differentiates it."""
    if generation == 1:
        # the planes added in order, as the JAX reduction over axis 0
        c = starlets.select(-3, 0)
        for k in range(1, starlets.shape[-3]):
            c = c + starlets.select(-3, k)
        return c
    if convolve2D is None:
        convolve2D = bspline_convolve
    scales = starlets.shape[-3] - 1
    c = starlets.select(-3, scales)
    for j in range(scales - 1, -1, -1):
        c = convolve2D(c, j) + starlets.select(-3, j)
    return c


def multiband_starlet_reconstruction(starlets, generation=2,
                                     convolve2D=None):
    """The (B, H, W) cube of (J + 1, B, H, W) coefficients, band by band:
    the JAX package's working version of the reference's broken body
    (scarlet_tpu/ops/wavelet.py:120-133)."""
    return starlet_reconstruction(starlets.transpose(0, 1), generation,
                                  convolve2D)


class Starlet:
    """An image together with its starlet coefficients (torch tensors).
    Ref: scarlet_tpu/ops/wavelet.py:136-208."""

    def __init__(self, image, coefficients, generation, convolve2D):
        self._image = image
        self._coeffs = coefficients
        self._generation = generation
        self._convolve2D = convolve2D
        self._norm = None

    @staticmethod
    def from_image(image, scales=None, generation=2, convolve2D=None):
        image = _as_tensor(image)
        if scales is None:
            scales = get_scales(image.shape)
        coefficients = starlet_transform(image, scales, generation,
                                         convolve2D)
        return Starlet(image, coefficients, generation, convolve2D)

    @staticmethod
    def from_coefficients(coefficients, generation=2, convolve2D=None):
        coefficients = _as_tensor(coefficients)
        image = starlet_reconstruction(coefficients, generation, convolve2D)
        return Starlet(image, coefficients, generation, convolve2D)

    @property
    def image(self):
        return self._image

    @image.setter
    def image(self, image):
        self._image = _as_tensor(image)
        self._coeffs = starlet_transform(self._image, None, self._generation,
                                         self._convolve2D)
        self._norm = None

    @property
    def coefficients(self):
        return self._coeffs

    @coefficients.setter
    def coefficients(self, coeffs):
        self._coeffs = _as_tensor(coeffs)
        self._image = starlet_reconstruction(self._coeffs, self._generation,
                                             self._convolve2D)

    @property
    def scales(self):
        return self._coeffs.shape[-3] - 1

    @property
    def generation(self):
        return self._generation

    @property
    def convolve2D(self):
        return self._convolve2D

    @property
    def norm(self):
        """The L2 norm per scale of the transform of a centred dirac
        (J + 1,), which scales sparsity thresholds; float64 on the host,
        as the JAX package's ``jnp.zeros`` dirac is under 64-bit mode
        (scarlet_tpu/ops/wavelet.py:196-208).  The transform is the same
        to the bit; the sum over the pixels is torch's, which XLA orders
        otherwise (they part by up to ~10 ulp)."""
        if self._norm is None:
            shape = tuple(self._image.shape[-2:])
            dirac = torch.zeros(shape, dtype=torch.float64)
            dirac[shape[0] // 2, shape[1] // 2] = 1.0
            seed = starlet_transform(dirac, scales=self.scales,
                                     generation=self._generation,
                                     convolve2D=self._convolve2D)
            self._norm = torch.sqrt(torch.sum(seed ** 2, dim=(-2, -1)))
        return self._norm


def _as_tensor(x):
    """A tensor as it is; anything else through numpy (in numpy's dtype)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def multiresolution_support(starlets, sigma, K=3, epsilon=1e-1, max_iter=20,
                            valid=None):
    """Ground-type significance masks of starlet coefficients, batched:
    the port of ``multiresolution_support_jax``
    (scarlet_tpu/ops/wavelet.py:254-312).

    starlets (..., J, H, W); sigma: the noise level, a float or a tensor
    of the leading shape; valid: optional (..., H, W) mask of real pixels
    (the per-scale std then runs over them only).  Per blend, iterate
    ``sigma_j <- std(c_j where |c_j| <= K sigma_j)`` until every scale
    with ``sigma_j > 0`` moves by less than ``epsilon`` relative, or
    ``max_iter`` times; the mask ``|c| > K sigma`` uses the sigma of the
    blend's last executed iteration.

    Under ``vmap`` the JAX loop keeps a converged blend's carry while the
    others run on.  Here every blend runs ``max_iter`` iterations with a
    converged blend's ``(sigma, sigma_last)`` frozen, which gives the same
    masks and reads nothing back from the device.  The std's sums
    accumulate in float64 and round to float32, so the CPU and the card
    take the same threshold decisions (float32 sums in their two orders
    part at roundoff).

    Returns the (..., J, H, W) int32 mask.
    """
    lead = starlets.shape[:-3]
    J, H, W = starlets.shape[-3:]
    c = starlets.reshape(-1, J, H, W)
    B = c.shape[0]
    dtype, dev = c.dtype, c.device
    if valid is None:
        validb = torch.ones((B, 1, H, W), dtype=torch.bool, device=dev)
    else:
        validb = (valid.reshape(B, 1, H, W) > 0)
    n_valid = torch.clamp_min(validb.sum(dim=(-2, -1), dtype=torch.int64),
                              1).to(torch.float64)              # (B, 1)
    tiny = torch.finfo(dtype).tiny

    def masked_std(x):
        mean = (torch.where(validb, x, 0.0).sum(
            dim=(-2, -1), dtype=torch.float64) / n_valid).to(dtype)
        d = x - mean[..., None, None]
        var = (torch.where(validb, d * d, 0.0).sum(
            dim=(-2, -1), dtype=torch.float64) / n_valid).to(dtype)
        return torch.sqrt(var)

    sigma = torch.as_tensor(sigma, dtype=dtype, device=dev)
    sig = sigma.reshape(-1, 1).expand(B, J).clone() if sigma.ndim \
        else torch.full((B, J), float(sigma), dtype=dtype, device=dev)
    sig_last = sig
    done = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    absc = c.abs()
    for _ in range(max_iter):
        keep = ~(absc > K * sig[..., None, None]) & validb
        nxt = masked_std(torch.where(keep, c, 0.0))
        conv = torch.where(nxt > 0, (nxt - sig).abs()
                           / torch.clamp_min(nxt, tiny) < epsilon,
                           True).all(dim=-1, keepdim=True)
        sig_last = torch.where(done, sig_last, sig)
        sig = torch.where(done, sig, nxt)
        done = done | conv
    mask = absc > K * sig_last[..., None, None]
    return mask.to(torch.int32).reshape(*lead, J, H, W)


def get_multiresolution_support(image, starlets, sigma, K=3, epsilon=1e-1,
                                max_iter=20, image_type="ground"):
    """Significance masks (K-sigma clipping per scale) of host (numpy)
    starlet coefficients: (J, H, W) int.  Host side, as
    scarlet_tpu/ops/wavelet.py:211-251, in its numpy arithmetic (the std
    of the coefficients times the int mask, the loop's early exit), so
    the host path decides like the JAX package's.  The "space" variant
    draws its noise image from numpy's global stream
    (``np.random.normal``), as the JAX package does: seed ``np.random``
    for the same mask on both sides.  Its clipping threshold is
    ``K sigma`` times the noise's per-scale std, with ``sigma`` as given:
    the per-iteration ``sigma_i`` only decides when to stop, in the
    reference and here."""
    assert image_type in ("ground", "space")
    image = np.asarray(image)
    starlets = np.asarray(starlets)

    if image_type == "space":
        noise_img = np.random.normal(size=image.shape)
        noise_starlet = starlet_transform(
            torch.from_numpy(noise_img), scales=len(starlets) - 1,
            generation=1).numpy()
        sigma_je = np.array([np.std(star) for star in noise_starlet])
        noise = image - starlets[-1]
        last_sigma_i = sigma
        for _ in range(max_iter):
            M = np.abs(starlets) > K * sigma * sigma_je[:, None, None]
            S = np.sum(M, axis=0) == 0
            sigma_i = np.std(noise * S)
            if np.abs(sigma_i - last_sigma_i) / sigma_i < epsilon:
                break
            last_sigma_i = sigma_i
        return M.astype(int)

    sigma_j = np.ones((len(starlets),), dtype=image.dtype) * sigma
    last_sigma_j = sigma_j
    for _ in range(max_iter):
        M = np.abs(starlets) > K * sigma_j[:, None, None]
        S = ~M
        sigma_j = np.std(starlets * S.astype(int), axis=(1, 2))
        cut = sigma_j > 0
        if np.all(np.abs(sigma_j[cut] - last_sigma_j[cut]) / sigma_j[cut]
                  < epsilon):
            break
        last_sigma_j = sigma_j
    return M.astype(int)


def _transform_host(x):
    return starlet_transform(torch.from_numpy(np.array(x))
                             ).numpy()


def _reconstruct_host(c):
    return starlet_reconstruction(torch.from_numpy(np.array(c))
                                  ).numpy()


def apply_wavelet_denoising(image, sigma=None, k=3, epsilon=1e-1, max_iter=20,
                            image_type="ground", positive=True):
    """Iterative starlet-domain denoising (Starck et al. 2011, section
    4.1) of a 2D host image; returns numpy.  The numpy steps and their
    dtypes are the JAX package's (scarlet_tpu/ops/wavelet.py:315-336):
    the int support times float coefficients promotes to float64, so the
    iterate is float64 after the first step; the transforms run in torch
    on the CPU."""
    image = np.asarray(image)
    image_coeffs = _transform_host(image)
    if sigma is None:
        sigma = np.median(np.absolute(image - np.median(image)))
    support = get_multiresolution_support(
        image, image_coeffs, sigma, k, epsilon, max_iter, image_type)
    x = _reconstruct_host(image_coeffs)
    for _ in range(max_iter):
        coeffs = _transform_host(x)
        x = x + _reconstruct_host(support * (image_coeffs - coeffs))
        if positive:
            x[x < 0] = 0
    return x
