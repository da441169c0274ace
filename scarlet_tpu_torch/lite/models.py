"""Lite blend model classes.

API mirrors scarlet.lite (reference scarlet/lite/models.py); the fit runs
in :mod:`scarlet_tpu_torch.lite.engine`: ``LiteBlend.fit`` packs all
components into structure-of-arrays tensors on the fit device, runs the
proximal-Adam loop there, and writes the result back into the component
objects, which hold host (CPU) tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..bbox import Box, overlapped_slices
from ..device import default_device
from ..ops import fft as fft_ops
from ..initialization import get_minimal_boxsize
from .parameters import LiteParameter, AdaproxParameter, FistaParameter
from .utils import insert_image, to_numpy
from . import engine

__all__ = [
    "LiteComponent",
    "LiteFactorizedComponent",
    "LiteSource",
    "LiteObservation",
    "LiteBlend",
]


def _param_value(p):
    return p.x if isinstance(p, LiteParameter) else torch.as_tensor(p)


class LiteComponent:
    """A (sed, morph) component anchored at ``bbox`` inside the blend.
    Ref: scarlet/lite/models.py:19-133."""

    def __init__(self, center, bbox, sed=None, morph=None, initialized=False,
                 bg_thresh=0.25, bg_rms=0):
        self._center = center
        self._bbox = bbox
        self._sed = sed
        self._morph = morph
        self.initialized = initialized
        self.bg_thresh = bg_thresh
        self.bg_rms = bg_rms

    @property
    def center(self):
        return self._center

    @property
    def bbox(self):
        return self._bbox

    @property
    def sed(self):
        return _param_value(self._sed) if self._sed is not None else None

    @property
    def morph(self):
        return _param_value(self._morph) if self._morph is not None else None

    def get_model(self, bbox=None):
        """(C, h, w) numpy model, or placed into ``bbox``."""
        model = to_numpy(self.sed)[:, None, None] * \
            to_numpy(self.morph)[None, :, :]
        if bbox is not None:
            slices = overlapped_slices(bbox, self.bbox)
            _model = np.zeros(bbox.shape, dtype=model.dtype)
            _model[slices[0]] = model[slices[1]]
            model = _model
        return model

    def resize(self):
        """Shrink or grow the box based on edge flux.
        Ref: lite/models.py:73-127.  Host-side; returns True if resized."""
        if self.bg_thresh is None:
            return False
        morph = to_numpy(self.morph)
        size = max(morph.shape)

        dist = 0
        while (
            np.all(morph[dist, :] == 0)
            and np.all(morph[-(dist + 1), :] == 0)
            and np.all(morph[:, dist] == 0)
            and np.all(morph[:, -(dist + 1)] == 0)
            and dist < size // 2
        ):
            dist += 1

        new_size = get_minimal_boxsize(size - 2 * dist)
        if new_size < size:
            dist = (size - new_size) // 2
            self.bbox.origin = (self.bbox.origin[0],
                                self.bbox.origin[1] + dist,
                                self.bbox.origin[2] + dist)
            self.bbox.shape = (self.bbox.shape[0], new_size, new_size)
            self._morph.shrink(dist)
            self.slices = overlapped_slices(self.model_bbox, self.bbox)
            return True

        model = self.get_model()
        edges = [model[:, :, 0], model[:, :, -1], model[:, 0, :],
                 model[:, -1, :]]
        edge_flux = np.array([np.sum(e) for e in edges])
        edge_mask = np.array([max(np.sum(e > 0), 1) for e in edges])
        bg_rms = to_numpy(self.bg_rms)
        if np.any(edge_flux / edge_mask > self.bg_thresh * np.mean(bg_rms)):
            new_size = get_minimal_boxsize(size + 1)
            dist = (new_size - size) // 2
            self.bbox.origin = (self.bbox.origin[0],
                                self.bbox.origin[1] - dist,
                                self.bbox.origin[2] - dist)
            self.bbox.shape = (self.bbox.shape[0], new_size, new_size)
            self._morph.grow(self.bbox.shape[1:], dist)
            self.slices = overlapped_slices(self.model_bbox, self.bbox)
            return True
        return False

    def __repr__(self):
        return "LiteComponent"


class LiteFactorizedComponent(LiteComponent):
    """Factorized component fitted by the engine: floored SED, the lite
    morphology prox chain (monotonicity about the brightest pixel within
    ``fit_center_radius`` of the center, threshold, center floor,
    normalization).  Ref: scarlet/lite/models.py:136-258.

    :meth:`LiteBlend.fit` runs the engine; :meth:`update` is the
    reference's eager per-component step, for custom gradients (the
    multiscale tutorial's ``WaveletBlend``).
    """

    def __init__(self, sed, morph, center, bbox, model_bbox, bg_rms,
                 bg_thresh=0.25, floor=1e-20, fit_center_radius=1):
        super().__init__(center, bbox, sed, morph, initialized=True,
                         bg_thresh=bg_thresh, bg_rms=bg_rms)
        self.fit_center_radius = fit_center_radius
        self.floor = floor
        self.model_bbox = model_bbox
        if isinstance(self._sed, LiteParameter):
            self._sed.grad = self.grad_sed
            self._sed.prox = self.prox_sed
        if isinstance(self._morph, LiteParameter):
            self._morph.grad = self.grad_morph
            self._morph.prox = self.prox_morph
        self.slices = overlapped_slices(model_bbox, bbox)

    def _boxed(self, input_grad, like):
        """The scene gradient's window of this component's box, on the
        device and in the dtype of ``like``."""
        grad = torch.zeros(self.bbox.shape, dtype=like.dtype,
                           device=like.device)
        grad[self.slices[1]] = torch.as_tensor(input_grad).to(
            like.device, like.dtype)[self.slices[0]]
        return grad

    def grad_sed(self, input_grad, sed, morph):
        """d(logL)/d(sed): project the scene gradient into the box and
        contract with the morphology.  Ref: lite/models.py:206-210."""
        morph = torch.as_tensor(morph)
        return torch.einsum("chw,hw->c", self._boxed(input_grad, morph),
                            morph)

    def grad_morph(self, input_grad, morph, sed):
        """d(logL)/d(morph). Ref: lite/models.py:212-216."""
        morph = torch.as_tensor(morph)
        return torch.einsum("c,chw->hw", torch.as_tensor(sed).to(morph),
                            self._boxed(input_grad, morph))

    def prox_sed(self, sed, prox_step=0):
        """Floor the SED. Ref: lite/models.py:218-222."""
        return torch.clamp_min(torch.as_tensor(sed), self.floor)

    @property
    def monotonicity(self):
        """The morphology's monotonicity constraint (K1 on the card)."""
        from ..models.constraint import MonotonicityConstraint

        return MonotonicityConstraint(
            neighbor_weight="angle", min_gradient=0,
            fit_center_radius=self.fit_center_radius)

    def prox_morph(self, morph, prox_step=0):
        """Monotonicity -> background threshold (or positivity) -> center
        floor -> max normalization.  Ref: lite/models.py:224-244."""
        morph = self.monotonicity(torch.as_tensor(morph), 0)
        if self.bg_thresh is not None:
            bg_thresh = torch.as_tensor(
                to_numpy(self.bg_rms) * self.bg_thresh).to(morph)
            model = self.sed.to(morph)[:, None, None] * morph[None, :, :]
            cut = torch.all(model < bg_thresh[:, None, None], dim=0)
            morph = torch.where(cut, 0.0, morph)
        else:
            morph = torch.clamp_min(morph, 0)
        cy, cx = morph.shape[0] // 2, morph.shape[1] // 2
        morph = morph.clone()
        morph[cy, cx] = torch.clamp_min(morph[cy, cx], self.floor)
        return morph / morph.max()

    def update(self, it, input_grad):
        """One eager step of both factors on the device of ``input_grad``
        (where the parameters and their optimizer states move first).
        Ref: lite/models.py:246-252."""
        device = torch.as_tensor(input_grad).device
        for p in (self._sed, self._morph):
            p.x = p.x.to(device)
            p.state = engine.map_tree(
                lambda a: a.to(device) if isinstance(a, torch.Tensor) else a,
                p.state)
        sed = self.sed
        self._sed.update(it, input_grad, self.morph)
        self._morph.update(it, input_grad, sed)

    def __repr__(self):
        return "LiteFactorizedComponent"


class LiteSource:
    """Components belonging to one astrophysical object.
    Ref: scarlet/lite/models.py:261-330."""

    def __init__(self, components, dtype=np.float32):
        self.components = components
        self.dtype = dtype
        self.flux = None
        self.flux_box = None

    @property
    def n_components(self):
        return len(self.components)

    @property
    def center(self):
        return self.components[0].center if not self.is_null else None

    @property
    def is_null(self):
        return self.n_components == 0

    @property
    def bbox(self):
        if self.n_components == 0:
            return Box((0, 0, 0))
        bbox = self.components[0].bbox
        for component in self.components[1:]:
            bbox = bbox | component.bbox
        return bbox

    def get_model(self, bbox=None, use_flux=False):
        if self.n_components == 0:
            return 0
        if use_flux:
            if bbox is None:
                return self.flux
            return insert_image(bbox, self.flux_box, self.flux)
        if bbox is None:
            bbox = self.bbox
        model = np.zeros(bbox.shape, dtype=self.dtype)
        for component in self.components:
            slices = overlapped_slices(bbox, component.bbox)
            model[slices[0]] += component.get_model()[slices[1]]
        return model

    def __repr__(self):
        return f"LiteSource<{len(self.components)}>"


class LiteObservation:
    """Multiband images with their variance, weights and PSFs, and the
    difference kernel to the model PSF.  Ref: scarlet/lite/models.py:333-476.

    Tensors live on ``device`` (default: the CUDA card, or the device of
    ``images`` if it is a tensor; ``"cpu"`` for the host); the
    initialization reads them on the host.  ``convolution_mode``: "fft"
    (centered FFT) or "real" (a per-band true convolution with the odd
    difference kernel, :func:`_depthwise_convolve`).
    """

    def __init__(self, images, variance, weights, psfs, model_psf=None,
                 noise_rms=None, bbox=None, padding=3,
                 convolution_mode="fft", device=None):
        device = default_device(device, images)

        def tensor(x, dtype=None):
            t = x if isinstance(x, torch.Tensor) else \
                torch.as_tensor(np.asarray(x))
            return t.to(device=device, dtype=dtype)

        self.images = tensor(images)
        self.variance = tensor(variance)
        self.weights = tensor(weights)
        self.psfs = tensor(psfs, self.images.dtype)
        if convolution_mode not in ("fft", "real"):
            raise ValueError("convolution_mode must be either 'fft' or "
                             f"'real', got {convolution_mode!r}")
        self.mode = convolution_mode
        if noise_rms is None:
            noise_rms = torch.sqrt(self.variance).mean(dim=(1, 2))
        self.noise_rms = tensor(noise_rms)

        self.model_psf = None if model_psf is None else tensor(model_psf)
        self.padding = padding
        if model_psf is not None:
            self.diff_kernel = fft_ops.match_psf(self.psfs, self.model_psf,
                                                 padding=padding)
            self.grad_kernel = fft_ops.Fourier(
                torch.flip(self.diff_kernel.image, (-2, -1)))
        else:
            self.diff_kernel = self.grad_kernel = None

        self.bbox = Box(tuple(self.images.shape)) if bbox is None else bbox

    @property
    def device(self):
        return self.images.device

    def convolve(self, image, mode=None, grad=False):
        """Convolve a (C, H, W) image to the observed seeing, in ``mode``
        (default: the observation's).  Ref: lite/models.py:376-410."""
        kernel = self.grad_kernel if grad else self.diff_kernel
        if kernel is None:
            return image
        if mode is None:
            mode = self.mode
        image = torch.as_tensor(image, device=self.device)
        if mode == "fft":
            return fft_ops.convolve(fft_ops.Fourier(image), kernel,
                                    axes=(1, 2), return_fourier=False)
        if mode == "real":
            return _depthwise_convolve(image, kernel.image)
        raise ValueError(f"mode must be 'fft' or 'real', got {mode!r}")

    def render(self, model):
        return self.convolve(model)

    @property
    def data(self):
        return self.images

    @property
    def shape(self):
        return tuple(self.images.shape)

    @property
    def n_bands(self):
        return self.images.shape[0]

    @property
    def dtype(self):
        return self.images.dtype

    def __getitem__(self, i):
        """The observation of band(s) ``i``, with the same model PSF,
        bounding box, padding and convolution mode."""
        images = self.images[i]
        variance = self.variance[i]
        weights = self.weights[i]
        psfs = self.psfs[i]
        noise_rms = self.noise_rms[i]
        if images.ndim == 2:
            images, variance, weights, psfs = (
                a[None] for a in (images, variance, weights, psfs))
            noise_rms = noise_rms.reshape(1)
        return LiteObservation(
            images, variance, weights, psfs, model_psf=self.model_psf,
            noise_rms=noise_rms, bbox=self.bbox, padding=self.padding,
            convolution_mode=self.mode, device=self.device)


def _depthwise_convolve(image, kernel):
    """True (flipped-kernel) per-band convolution of (C, H, W) ``image``
    with the odd (C, kh, kw) ``kernel``, "same" size: a grouped
    ``F.conv2d`` (cross-correlation) with the flipped kernel, which
    centers like the FFT convention for odd kernels (ref
    scarlet_tpu/lite/models.py:350-365).  Float32 in full float32 on the
    card (``engine.pin_float32`` turns cuDNN's TF32 off)."""
    C = image.shape[0]
    kh, kw = kernel.shape[-2:]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"the kernel must be odd-sized, got {(kh, kw)}")
    engine.pin_float32(image.device)
    k = torch.flip(kernel, (-2, -1)).to(device=image.device)
    return F.conv2d(image[None].to(k.dtype), k[:, None], padding="same",
                    groups=C)[0]


class LiteBlend:
    """A blend: sources plus one observation, fitted by the engine.
    Ref: scarlet/lite/models.py:479-624."""

    def __init__(self, sources, observation):
        self.sources = sources
        self.components = []
        for source in sources:
            self.components.extend(source.components)
        self.observation = observation
        self.it = 0
        self.loss = []

    @property
    def bbox(self):
        return self.observation.bbox

    def get_model(self, convolve=False, use_flux=False):
        """(C, H, W) numpy model of the blend."""
        model = np.zeros(self.bbox.shape,
                         dtype=to_numpy(self.observation.images).dtype)
        if use_flux:
            for src in self.sources:
                slices = overlapped_slices(self.bbox, src.flux_box)
                model[slices[0]] += to_numpy(src.flux)
        else:
            for component in self.components:
                slices = overlapped_slices(self.bbox, component.bbox)
                model[slices[0]] += component.get_model()[slices[1]]
            if convolve:
                return to_numpy(self.observation.convolve(
                    torch.from_numpy(model)))
        return model

    def grad_logL(self):
        """Eager gradient of logL with respect to the unconvolved model, on
        the observation's device; appends the loss.
        Ref: lite/models.py:537-545."""
        obs = self.observation
        model = torch.as_tensor(self.get_model(convolve=True),
                                device=obs.device)
        self.loss.append(float(
            -0.5 * torch.sum(obs.weights * (obs.images - model) ** 2)))
        grad = obs.weights * (model - obs.images)
        return obs.convolve(grad, grad=True)

    def fit_spectra(self, clip=False):
        """Joint linear least-squares fit of all SEDs given the current
        morphologies (host numpy).  Ref: lite/models.py:547-581."""
        from .initialization import multifit_seds

        morphs = [to_numpy(c.morph) for c in self.components]
        boxes = [c.bbox[1:] for c in self.components]
        fit_seds = multifit_seds(self.observation, morphs, boxes)
        for idx, component in enumerate(self.components):
            sed = torch.from_numpy(np.maximum(fit_seds[idx], 0))
            if isinstance(component._sed, LiteParameter):
                component._sed.x = sed.to(component._sed.x.device)
            else:
                component._sed = sed

        if clip:
            components = []
            for src in self.sources:
                kept = [
                    c for c in src.components
                    if np.any(to_numpy(c.sed) > 0)
                    and np.any(to_numpy(c.morph) > 0)
                ]
                src.components = kept
                components.extend(kept)
            self.components = components
        else:
            for c in self.components:
                if isinstance(c, LiteFactorizedComponent):
                    c._sed.x = c.prox_sed(c.sed)
        return self

    @property
    def log_likelihood(self):
        return np.array(self.loss)

    # -- engine fit --------------------------------------------------------
    def engine_setup(self, e_rel=1e-4, min_iter=1, bucket_mode="single",
                     scene_shape=None, box_size=None, n_slots=None,
                     fft_shape=None, device=None, platform=None):
        """The (config, data, state) of the engine, on ``device`` (default:
        the observation's) -- the entry point of batched fitting
        (:mod:`scarlet_tpu_torch.parallel`).

        ``platform`` ("cuda" or "cpu") is where the fit will run, which
        picks the config's kernel branches (``use_pallas``,
        ``use_pallas_scene``, ``packed_morphs``); it defaults to
        ``device``'s type.  A CPU worker builds a card's config with
        ``device="cpu", platform="cuda"`` (scarlet_tpu/lite/models.py:
        480-485, 677-689).

        ``bucket_mode``: "single" packs every component into one box
        bucket with per-component logical-box masks; "per-size" groups
        components by their box size.

        Layout overrides build this blend to a shared layout so distinct
        blends stack into one batch (``parallel.pack_blends``):
        ``scene_shape`` zero-pads images/weights bottom-right (weight 0
        never enters the likelihood); ``box_size`` forces the single
        bucket's box (odd); ``n_slots`` pads the component count with
        ``comp_active=False`` slots; ``fft_shape`` overrides the FFT shape.
        """
        if device is None:
            device = self.observation.device
        if bucket_mode not in ("single", "per-size"):
            raise ValueError(
                f"bucket_mode must be 'single' or 'per-size', "
                f"got {bucket_mode!r}")
        if bucket_mode != "single" and (box_size is not None or
                                        n_slots is not None):
            raise ValueError("layout overrides require bucket_mode='single'")
        obs = self.observation
        comps = self.components
        C, H, W = obs.shape
        images = to_numpy(obs.images)
        weights = to_numpy(obs.weights)
        scene_mask = None
        if scene_shape is not None:
            if scene_shape[0] != C or scene_shape[1] < H or \
                    scene_shape[2] < W:
                raise ValueError(
                    f"scene_shape {scene_shape} cannot hold {(C, H, W)}")
            pad = ((0, 0), (0, scene_shape[1] - H), (0, scene_shape[2] - W))
            images = np.pad(images, pad)
            weights = np.pad(weights, pad)
            # clip model flux at the true scene edge, so the shared-layout
            # fit equals this blend's natural-layout fit
            scene_mask = np.zeros(scene_shape[1:], dtype=images.dtype)
            scene_mask[:H, :W] = 1.0
            _, H, W = scene_shape
        dtype = images.dtype

        # --- size buckets, capped at the scene size ---
        cap = max(H, W) + 1
        sizes = []
        for c in comps:
            size = min(max(c.bbox.shape[-2], c.bbox.shape[-1]), cap)
            if size % 2 == 0:
                size += 1
            sizes.append(size)
        if bucket_mode == "single":
            sizes = [max(sizes)] * len(sizes)
            if box_size is not None:
                size = min(int(box_size), cap)
                if size % 2 == 0:
                    size += 1
                if size < max(sizes):
                    raise ValueError(
                        f"box_size {box_size} smaller than required "
                        f"{max(sizes)}")
                sizes = [size] * len(sizes)
        bucket_sizes = sorted(set(sizes))
        bucket_of = {s: b for b, s in enumerate(bucket_sizes)}
        nb = len(bucket_sizes)

        if obs.diff_kernel is not None:
            diff_kernel = to_numpy(obs.diff_kernel.image)
            if fft_shape is None:
                # smallest exact same-crop (even, 5-smooth) shape
                fft_shape = fft_ops.minimal_same_fft_shape(
                    images, diff_kernel, axes=(1, 2))
        else:
            fft_shape = None
            diff_kernel = None

        bg_threshes = {c.bg_thresh for c in comps}
        if len(bg_threshes) != 1:
            raise ValueError(
                "the engine needs one bg_thresh across components")
        bg_thresh = bg_threshes.pop()

        first = comps[0]
        fc_radius = getattr(first, "fit_center_radius", 1) or 1
        floor = getattr(first, "floor", 1e-20)
        # FISTA when every SED is a FistaParameter (as the JAX package's)
        use_fista = all(isinstance(c._sed, FistaParameter) for c in comps)

        # --- per-bucket state arrays ---
        counts = [sizes.count(s) for s in bucket_sizes]
        if n_slots is not None:
            if n_slots < counts[0]:
                raise ValueError(
                    f"n_slots {n_slots} smaller than component count "
                    f"{counts[0]}")
            counts = [int(n_slots)]
        seds = [np.zeros((k, C), dtype=dtype) for k in counts]
        morphs = [np.zeros((k, s, s), dtype=dtype)
                  for k, s in zip(counts, bucket_sizes)]
        # null (padding) slots keep a centered origin so they never widen
        # the overhang-derived scene_pad
        origins = [np.tile(np.asarray([[(H - s) // 2, (W - s) // 2]],
                                      np.int32), (k, 1))
                   for k, s in zip(counts, bucket_sizes)]
        m_sed = [np.zeros_like(a) for a in seds]
        v_sed = [np.zeros_like(a) for a in seds]
        vhat_sed = [np.zeros_like(a) for a in seds]
        m_mor = [np.zeros_like(a) for a in morphs]
        v_mor = [np.zeros_like(a) for a in morphs]
        vhat_mor = [np.zeros_like(a) for a in morphs]
        z_sed = [np.zeros_like(a) for a in seds]
        z_mor = [np.zeros_like(a) for a in morphs]
        t_sed = [np.ones((k,), dtype=dtype) for k in counts]
        t_mor = [np.ones((k,), dtype=dtype) for k in counts]
        fista_steps = [np.zeros((k,), dtype=dtype) for k in counts]
        box_masks = [np.zeros((k, s, s), dtype=dtype)
                     for k, s in zip(counts, bucket_sizes)]

        slots = [0] * nb
        placements = []   # per component: (bucket, slot, dy, dx, h, w,
                          #                 cy, cx, h0, w0)
        for ci, c in enumerate(comps):
            b = bucket_of[sizes[ci]]
            Hb = bucket_sizes[b]
            k = slots[b]
            slots[b] += 1

            _, h0, w0 = c.bbox.shape
            morph_k = to_numpy(c.morph)
            oy, ox = c.bbox.origin[-2], c.bbox.origin[-1]
            # center-crop morphologies larger than the bucket
            cy = (h0 - Hb) // 2 if h0 > Hb else 0
            cx = (w0 - Hb) // 2 if w0 > Hb else 0
            h = min(h0, Hb)
            w = min(w0, Hb)
            morph_k = morph_k[cy:cy + h, cx:cx + w]
            oy += cy
            ox += cx
            dy = (Hb - h) // 2
            dx = (Hb - w) // 2
            placements.append((b, k, dy, dx, h, w, cy, cx, h0, w0))
            seds[b][k] = to_numpy(c.sed)
            morphs[b][k, dy:dy + h, dx:dx + w] = morph_k
            box_masks[b][k, dy:dy + h, dx:dx + w] = 1.0
            origins[b][k] = (oy - dy, ox - dx)
            if isinstance(c._sed, AdaproxParameter):
                st = c._sed.state
                m_sed[b][k] = to_numpy(st.m)
                v_sed[b][k] = to_numpy(st.v)
                vhat_sed[b][k] = np.maximum(to_numpy(st.vhat), 0)
            if isinstance(c._morph, AdaproxParameter):
                st = c._morph.state
                crop = (slice(cy, cy + h), slice(cx, cx + w))
                m_mor[b][k, dy:dy + h, dx:dx + w] = to_numpy(st.m)[crop]
                v_mor[b][k, dy:dy + h, dx:dx + w] = to_numpy(st.v)[crop]
                vhat_mor[b][k, dy:dy + h, dx:dx + w] = np.maximum(
                    to_numpy(st.vhat)[crop], 0)
            if use_fista:
                crop = (slice(cy, cy + h), slice(cx, cx + w))
                z_sed[b][k] = to_numpy(c._sed.state.z)
                t_sed[b][k] = float(c._sed.state.t)
                z_mor[b][k, dy:dy + h, dx:dx + w] = \
                    to_numpy(c._morph.state.z)[crop]
                t_mor[b][k] = float(c._morph.state.t)
                fista_steps[b][k] = float(c._sed.step)
        self._engine_placements = placements

        # exact scene padding: the largest box overhang past the scene
        # edges, plus one
        overhang = 1
        for b, Hb in enumerate(bucket_sizes):
            if counts[b] == 0:
                continue
            overhang = max(
                overhang,
                -origins[b].min(initial=0),
                (origins[b][:, 0] + Hb - H).max(initial=0),
                (origins[b][:, 1] + Hb - W).max(initial=0),
            )
        scene_pad = min(int(overhang) + 1, max(bucket_sizes))

        if platform is None:
            platform = torch.device(device).type
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"platform must be 'cuda' or 'cpu', got "
                             f"{platform!r}")
        accel = platform == "cuda"
        mono_n_iters = []
        for s in bucket_sizes:
            _, _, n_it = engine.monotonicity_tables((s, s), fc_radius,
                                                    "angle")
            mono_n_iters.append(n_it)

        config = engine.LiteFitConfig(
            scene_shape=(C, H, W),
            box_shapes=tuple((s, s) for s in bucket_sizes),
            bucket_counts=tuple(counts),
            fft_shape=fft_shape,
            mono_n_iters=tuple(mono_n_iters),
            floor=floor,
            bg_thresh=bg_thresh,
            e_rel=e_rel,
            min_iter=min_iter,
            fit_center_radius=fc_radius,
            # the JAX package's accelerator branches on the card
            # (scarlet_tpu/lite/models.py:676-689); the convolution stays
            # "fft"
            use_pallas=accel,
            use_pallas_scene=accel,
            packed_morphs=accel,
            scene_pad=scene_pad,
            optimizer="fista" if use_fista else "adaprox",
        )

        data = engine.make_blend_data(
            images, weights, diff_kernel, to_numpy(obs.noise_rms), config,
            device=device)
        data = data._replace(box_masks=tuple(
            torch.from_numpy(m).to(device) for m in box_masks))
        if scene_mask is not None:
            data = data._replace(
                scene_mask=torch.from_numpy(scene_mask).to(device))

        def dev(a):
            return torch.from_numpy(a).to(device)

        if use_fista:
            data = data._replace(fista_step=tuple(dev(f)
                                                  for f in fista_steps))
            sed_opt = tuple(engine.FistaState(dev(z), dev(t))
                            for z, t in zip(z_sed, t_sed))
            morph_opt = tuple(engine.FistaState(dev(z), dev(t))
                              for z, t in zip(z_mor, t_mor))
        else:
            def opt(x, m, v, vh):
                return engine.init_adaprox_state(dev(x), m=m, v=v, vhat=vh)

            sed_opt = tuple(opt(*a)
                            for a in zip(seds, m_sed, v_sed, vhat_sed))
            morph_opt = tuple(opt(*a)
                              for a in zip(morphs, m_mor, v_mor, vhat_mor))
        comp_active = [
            np.arange(k) < slots[b] for b, k in enumerate(counts)
        ]
        state = engine.make_blend_state(
            seds, morphs, origins, comp_active=comp_active,
            sed_opt=sed_opt, morph_opt=morph_opt, device=device)
        state = state._replace(
            it=torch.tensor(self.it, dtype=torch.int32, device=device))
        return config, data, state

    def _write_back(self, state):
        """Copy a fitted (one-blend) engine state back into the
        components, on the host."""
        host = engine.map_tree(to_numpy, state)

        def embed(sub, cy, cx, h, w, h0, w0):
            """Place the engine's (possibly cropped) box back into the
            component's original box shape."""
            if h0 == h and w0 == w:
                return torch.from_numpy(np.array(sub))
            full = np.zeros((h0, w0), dtype=sub.dtype)
            full[cy:cy + h, cx:cx + w] = sub
            return torch.from_numpy(full)

        for ci, c in enumerate(self.components):
            b, k, dy, dx, h, w, cy, cx, h0, w0 = self._engine_placements[ci]
            sl = (slice(dy, dy + h), slice(dx, dx + w))
            sed = torch.from_numpy(np.array(host.seds[b][k]))
            morph = embed(host.morphs[b][k][sl], cy, cx, h, w, h0, w0)
            fista = isinstance(host.sed_opt[b], engine.FistaState)
            if isinstance(c._sed, LiteParameter):
                c._sed.x = sed
                if isinstance(c._sed, AdaproxParameter) and not fista:
                    c._sed.state = engine.AdaproxState(*(
                        torch.from_numpy(np.array(a[k]))
                        for a in host.sed_opt[b]))
                elif isinstance(c._sed, FistaParameter) and fista:
                    opt = host.sed_opt[b]
                    c._sed.state = engine.FistaState(
                        z=torch.from_numpy(np.array(opt.z[k])),
                        t=torch.from_numpy(np.array(opt.t[k])))
            else:
                c._sed = sed
            if isinstance(c._morph, LiteParameter):
                c._morph.x = morph
                if isinstance(c._morph, AdaproxParameter) and not fista:
                    c._morph.state = engine.AdaproxState(*(
                        embed(a[k][sl], cy, cx, h, w, h0, w0)
                        for a in host.morph_opt[b]))
                elif isinstance(c._morph, FistaParameter) and fista:
                    opt = host.morph_opt[b]
                    c._morph.state = engine.FistaState(
                        z=embed(opt.z[k][sl], cy, cx, h, w, h0, w0),
                        t=torch.from_numpy(np.array(opt.t[k])))
            else:
                c._morph = morph

    def fit(self, max_iter, e_rel=1e-4, min_iter=1, resize=10, reweight=True,
            bucket_mode="single", device=None):
        """Fit all components with the engine on ``device`` (default: the
        observation's).

        ``resize``: every ``resize`` iterations the fit stops for a
        host-side box-resize check (grow/shrink), the reference cadence
        (lite/models.py:613-616); each segment rebuilds the engine setup.
        ``resize=None`` runs one uninterrupted segment.

        Returns (iterations, last logL).
        """
        from .measure import weight_sources

        total = 0
        segment = max_iter if resize is None else int(resize)
        while total < max_iter:
            n = min(segment, max_iter - total)
            config, data, state = self.engine_setup(
                e_rel, min_iter, bucket_mode=bucket_mode, device=device)
            state, losses = engine.fit_scan(state, data, config, n)
            ran = int(state.it) - self.it
            self.loss.extend(to_numpy(losses)[:ran].tolist())
            self.it = int(state.it)
            self._write_back(state)
            total += n
            if ran < n:       # converged inside the segment
                break
            if resize is not None and total < max_iter:
                for c in self.components:
                    if hasattr(c, "resize"):
                        c.resize()
        if reweight:
            weight_sources(self)
        return self.it, (self.loss[-1] if self.loss else np.nan)
