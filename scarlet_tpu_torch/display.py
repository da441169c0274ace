"""Visualization: RGB mapping and scene/source plotting (host-side
numpy and matplotlib, astropy's Lupton mappings where astropy is
installed).  Port of ``scarlet_tpu/display.py``.

Tensors, on any device, become numpy arrays at the drawing boundary only,
through :func:`scarlet_tpu_torch.lite.utils.to_numpy`.  A model is
rendered through ``observation.render`` on the observation's device, in
float64 from the figure's float64 accumulator.  The figure functions of
the model tree draw the RGB panels of :func:`scene_panels`,
:func:`source_panels` and :func:`observation_panels`, which need numpy
only (no matplotlib).

Behavioral reference: scarlet/display.py.
"""
from __future__ import annotations

import numpy as np
import torch

from .bbox import Box
from .lite.utils import to_numpy

__all__ = [
    "channels_to_rgb",
    "LinearPercentileNorm",
    "AsinhPercentileNorm",
    "img_to_3channel",
    "img_to_rgb",
    "show_likelihood",
    "show_observation",
    "show_scene",
    "show_sources",
    "get_extent",
]

panel_size = 4.0

# fixed wavelength-ordered channel -> RGB weight tables for 1..7 channels
# (ref: scarlet/display.py:11-84)
_RGB_MAPS = {}


def channels_to_rgb(channels):
    """Linear (3, channels) map of wavelength-ordered channels onto RGB (a
    copy: callers may edit it).  Ref: scarlet/display.py:11-84.
    """
    assert channels in range(0, 8), \
        f"No mapping has been implemented for {channels} channels"
    if channels in _RGB_MAPS:
        return _RGB_MAPS[channels].copy()

    channel_map = np.zeros((3, channels))
    if channels == 1:
        channel_map[:, 0] = 1
    elif channels == 2:
        channel_map[0, 1] = 0.667
        channel_map[1, 1] = 0.333
        channel_map[1, 0] = 0.333
        channel_map[2, 0] = 0.667
        channel_map /= 0.667
    elif channels == 3:
        channel_map[0, 2] = 1
        channel_map[1, 1] = 1
        channel_map[2, 0] = 1
    elif channels == 4:
        channel_map[0, 3] = 1
        channel_map[0, 2] = 0.333
        channel_map[1, 2] = 0.667
        channel_map[1, 1] = 0.667
        channel_map[2, 1] = 0.333
        channel_map[2, 0] = 1
        channel_map /= 1.333
    elif channels == 5:
        channel_map[0, 4] = 1
        channel_map[0, 3] = 0.667
        channel_map[1, 3] = 0.333
        channel_map[1, 2] = 1
        channel_map[1, 1] = 0.333
        channel_map[2, 1] = 0.667
        channel_map[2, 0] = 1
        channel_map /= 1.667
    elif channels == 6:
        channel_map[0, 5] = 1
        channel_map[0, 4] = 0.667
        channel_map[0, 3] = 0.333
        channel_map[1, 4] = 0.333
        channel_map[1, 3] = 0.667
        channel_map[1, 2] = 0.667
        channel_map[1, 1] = 0.333
        channel_map[2, 2] = 0.333
        channel_map[2, 1] = 0.667
        channel_map[2, 0] = 1
        channel_map /= 2
    elif channels == 7:
        channel_map[:, 6] = 2 / 3.0
        channel_map[0, 5] = 1
        channel_map[0, 4] = 0.667
        channel_map[0, 3] = 0.333
        channel_map[1, 4] = 0.333
        channel_map[1, 3] = 0.667
        channel_map[1, 2] = 0.667
        channel_map[1, 1] = 0.333
        channel_map[2, 2] = 0.333
        channel_map[2, 1] = 0.667
        channel_map[2, 0] = 1
        channel_map /= 2
    _RGB_MAPS[channels] = channel_map
    return channel_map.copy()


class _Mapping:
    """Self-contained Lupton-style intensity mapping (API-compatible subset
    of astropy.visualization.lupton_rgb mappings; used directly when astropy
    is unavailable in the runtime)."""

    def __init__(self, minimum=None, image=None):
        self.minimum = minimum

    def intensity(self, image_r, image_g, image_b):
        return (image_r + image_g + image_b) / 3.0

    def _scale(self, I):
        raise NotImplementedError

    def make_rgb_image(self, image_r, image_g, image_b):
        image_r = np.asarray(to_numpy(image_r), dtype=float)
        image_g = np.asarray(to_numpy(image_g), dtype=float)
        image_b = np.asarray(to_numpy(image_b), dtype=float)
        I = self.intensity(image_r, image_g, image_b)
        fac = self._scale(I)
        rgb = np.stack([image_r * fac, image_g * fac, image_b * fac], axis=-1)
        # truncate while preserving hue: scale by the max channel overflow
        peak = rgb.max(axis=-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            scale = np.where(peak > 1, 1.0 / np.where(peak > 0, peak, 1), 1.0)
        rgb = rgb * scale[..., None]
        rgb = np.clip(rgb, 0, 1)
        return (rgb * 255).astype(np.uint8)


class LinearMapping(_Mapping):
    """Linear stretch between minimum and maximum."""

    def __init__(self, minimum=None, maximum=None, image=None):
        if image is not None and (minimum is None or maximum is None):
            image = to_numpy(image)
            minimum = np.min(image) if minimum is None else minimum
            maximum = np.max(image) if maximum is None else maximum
        super().__init__(minimum=minimum)
        self.maximum = maximum

    def _scale(self, I):
        rng = self.maximum - self.minimum
        rng = rng if rng > 0 else 1.0
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(I > self.minimum,
                            (np.clip((I - self.minimum) / rng, 0, 1))
                            / np.where(I != 0, I, 1),
                            0.0)


class AsinhMapping(_Mapping):
    """asinh stretch: f(I) = asinh(Q (I-min)/stretch) / Q."""

    def __init__(self, minimum=0, stretch=1, Q=8, image=None):
        super().__init__(minimum=minimum)
        self.stretch = stretch
        self.Q = Q

    def _scale(self, I):
        Q = max(self.Q, 1e-10)
        frac = (I - self.minimum) / self.stretch
        with np.errstate(invalid="ignore", divide="ignore"):
            f = np.arcsinh(Q * frac) / np.arcsinh(Q)
            return np.where(I > self.minimum,
                            np.clip(f, 0, 1) / np.where(I != 0, I, 1), 0.0)


def _lupton():
    """Prefer astropy's reference implementations when present."""
    try:
        from astropy.visualization.lupton_rgb import (
            LinearMapping as _LM, AsinhMapping as _AM)
        return _LM, _AM
    except ImportError:
        return LinearMapping, AsinhMapping


class LinearPercentileNorm:
    """Linear norm between image percentiles. Ref: display.py:87-100."""

    def __new__(cls, img, percentiles=(1, 99)):
        LM, _ = _lupton()
        assert len(percentiles) == 2
        vmin, vmax = np.percentile(to_numpy(img), percentiles)
        return LM(minimum=vmin, maximum=vmax)


class AsinhPercentileNorm:
    """Asinh norm between image percentiles. Ref: display.py:103-119."""

    def __new__(cls, img, percentiles=(1, 99)):
        _, AM = _lupton()
        assert len(percentiles) == 2
        vmin, vmax = np.percentile(to_numpy(img), percentiles)
        stretch = vmax - vmin
        beta = stretch / np.sinh(1)
        return AM(minimum=vmin, stretch=stretch, Q=beta)


def img_to_3channel(img, channel_map=None, fill_value=0):
    """Project a (C, H, W) cube (numpy, or a tensor on any device) onto 3
    RGB planes.  Ref: display.py:122-158."""
    img = to_numpy(img)
    assert img.ndim in (2, 3)
    if img.ndim == 2:
        img = img[None]
    C = len(img)
    if channel_map is None:
        channel_map = channels_to_rgb(C)
    else:
        assert channel_map.shape == (3, len(img))
    _, ny, nx = img.shape
    rgb = np.dot(channel_map, img.reshape(C, -1)).reshape(3, ny, nx)
    if hasattr(rgb, "mask"):
        rgb = rgb.filled(fill_value)
    return rgb


def img_to_rgb(img, channel_map=None, fill_value=0, norm=None, mask=None):
    """(C, H, W) cube (numpy, or a tensor on any device) -> uint8 RGB
    image.  Ref: display.py:161-189."""
    LM, _ = _lupton()
    RGB = img_to_3channel(img, channel_map=channel_map)
    if norm is None:
        norm = LM(image=RGB)
    rgb = norm.make_rgb_image(*RGB)
    if mask is not None:
        rgb = np.dstack([rgb, ~to_numpy(mask) * 255])
    return rgb


def get_extent(bbox):
    return [bbox.start[-1], bbox.stop[-1], bbox.start[-2], bbox.stop[-2]]


def _render(observation, model):
    """``observation.render`` of a host (C, H, W) model, in float64 on the
    observation's device; a host float64 array."""
    model = torch.as_tensor(np.asarray(model, np.float64),
                            device=observation.device)
    return to_numpy(observation.render(model))


def _mask(observation):
    """Pixels of zero weight in every channel, or None if there are none."""
    mask = np.sum(to_numpy(observation.weights), axis=0) == 0
    return None if np.all(mask == 0) else mask


def show_likelihood(blend, figsize=None, **kwargs):
    """Loss-history plot. Ref: display.py:195-201."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    fig, ax = plt.subplots(1, 1, figsize=figsize)
    ax.plot(np.asarray(blend.log_likelihood), **kwargs)
    ax.set_xlabel("Iteration")
    ax.xaxis.set_major_locator(MaxNLocator(integer=True))
    ax.set_ylabel("log-Likelihood")
    return fig


def observation_panels(observation, norm=None, channel_map=None,
                       show_psf=False):
    """The RGB panels :func:`show_observation` draws, as (title, rgb,
    extent) in order (extent None: the PSF panel's pixel grid); numpy
    only, no matplotlib."""
    data = to_numpy(observation.data)
    panels = [("Observation", img_to_rgb(
        data, norm=norm, channel_map=channel_map, mask=_mask(observation)),
        get_extent(observation.bbox))]
    if show_psf:
        psf_image = np.zeros(data.shape)
        if observation.psf is not None:
            psf_model = np.array(to_numpy(observation.psf.get_model()))
            psf_model *= (data.mean(axis=0).max()
                          / psf_model.mean(axis=0).max())
            shift = tuple(
                psf_image.shape[c] // 2 - psf_model.shape[c] // 2
                for c in range(psf_image.ndim)
            )
            model_box = Box(psf_model.shape) + shift
            model_box.insert_into(psf_image, psf_model)
        panels.append(("PSF", img_to_rgb(psf_image, norm=norm), None))
    return panels


def show_observation(observation, norm=None, channel_map=None, sky_coords=None,
                     show_psf=False, add_labels=True, figsize=None):
    """Standardized observation plot. Ref: display.py:204-272."""
    import matplotlib.pyplot as plt

    panels = 1 if show_psf is False else 2
    if figsize is None:
        figsize = (panel_size * panels, panel_size)
    fig, ax = plt.subplots(1, panels, figsize=figsize)
    if not hasattr(ax, "__iter__"):
        ax = (ax,)

    for a, (title, rgb, extent) in zip(ax, observation_panels(
            observation, norm=norm, channel_map=channel_map,
            show_psf=show_psf)):
        if extent is None:
            a.imshow(rgb, origin="lower")
        else:
            a.imshow(rgb, extent=extent, origin="lower")
        a.set_title(title)

    if add_labels:
        assert sky_coords is not None, "Provide sky_coords for labeled objects"
        for k, center in enumerate(sky_coords):
            if hasattr(observation, "get_pixel"):
                center_ = observation.get_pixel(center)
                color = "w" if observation.C > 1 else "r"
            else:
                center_ = np.asarray(center)
                color = "w" if observation.data.shape[0] > 1 else "r"
            ax[0].text(*center_[::-1], k, color=color, ha="center",
                       va="center")

    fig.tight_layout()
    return fig


def scene_panels(sources, observation=None, norm=None, channel_map=None,
                 show_model=True, show_observed=False, show_rendered=False,
                 show_residual=False):
    """The RGB panels :func:`show_scene` draws, as (title, rgb, extent) in
    order; numpy only, no matplotlib."""
    mask = None
    if observation is not None:
        mask = _mask(observation)

    model_frame = sources[0].frame
    model = np.zeros(model_frame.shape)
    for src in sources:
        model = model + to_numpy(src.get_model(frame=model_frame))

    panels = []
    if show_model:
        extent = get_extent(model_frame.bbox)
        panels.append(("Model", img_to_rgb(model, norm=norm,
                                           channel_map=channel_map), extent))

    if show_rendered or show_residual:
        model = _render(observation, model)
        extent = get_extent(observation.bbox)

    if show_rendered:
        panels.append(("Model Rendered", img_to_rgb(
            model, norm=norm, channel_map=channel_map, mask=mask), extent))

    if show_observed:
        panels.append(("Observation", img_to_rgb(
            observation.data, norm=norm, channel_map=channel_map,
            mask=mask), extent))

    if show_residual:
        residual = to_numpy(observation.data) - model
        norm_ = LinearPercentileNorm(residual)
        panels.append(("Residual", img_to_rgb(
            residual, norm=norm_, channel_map=channel_map, mask=mask),
            extent))
    return panels


def show_scene(sources, observation=None, norm=None, channel_map=None,
               show_model=True, show_observed=False, show_rendered=False,
               show_residual=False, add_labels=True, add_boxes=False,
               figsize=None, linear=True):
    """Model/observed/rendered/residual panels. Ref: display.py:275-436."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle, Polygon

    if show_observed or show_rendered or show_residual:
        assert observation is not None, \
            "Provide matched observation to show observed frame"

    panels = sum((show_model, show_observed, show_rendered, show_residual))
    if linear:
        if figsize is None:
            figsize = (panel_size * panels, panel_size)
        fig, ax = plt.subplots(1, panels, figsize=figsize)
    else:
        columns = int(np.ceil(panels / 2))
        if figsize is None:
            figsize = (panel_size * columns, panel_size * 2)
        fig = plt.figure(figsize=figsize)
        ax = [fig.add_subplot(2, columns, n + 1) for n in range(panels)]
    if not hasattr(ax, "__iter__"):
        ax = (ax,)

    for a, (title, rgb, extent) in zip(ax, scene_panels(
            sources, observation, norm=norm, channel_map=channel_map,
            show_model=show_model, show_observed=show_observed,
            show_rendered=show_rendered, show_residual=show_residual)):
        a.imshow(rgb, extent=extent, origin="lower")
        a.set_title(title)

    model_frame = sources[0].frame
    for k, src in enumerate(sources):
        if add_boxes:
            panel = 0
            box_kwargs = {"facecolor": "none", "edgecolor": "w", "lw": 0.5}
            if show_model:
                extent = get_extent(src.bbox)
                rect = Rectangle(
                    (extent[0], extent[2]),
                    extent[1] - extent[0],
                    extent[3] - extent[2],
                    **box_kwargs)
                ax[panel].add_artist(rect)
                panel = 1
            if observation is not None:
                start = src.bbox.start[-2:][::-1]
                stop = src.bbox.stop[-2:][::-1]
                points = (start, (start[0], stop[1]), stop, (stop[0], start[1]))
                coords = [
                    observation.get_pixel(model_frame.get_sky_coord(p))
                    for p in points
                ]
                for panel in range(panel, panels):
                    poly = Polygon(coords, closed=True, **box_kwargs)
                    ax[panel].add_artist(poly)

        if add_labels and hasattr(src, "center") and src.center is not None:
            center = to_numpy(src.center)
            panel = 0
            if show_model:
                ax[panel].text(*center[::-1], k, color="w", ha="center",
                               va="center")
                panel = 1
            if observation is not None:
                center_ = observation.get_pixel(
                    model_frame.get_sky_coord(center))
                for panel in range(panel, panels):
                    ax[panel].text(*center_[::-1], k, color="w", ha="center",
                                   va="center")

    fig.tight_layout()
    return fig


def source_panels(sources, observation=None, norm=None, channel_map=None,
                  show_model=True, show_observed=False, show_rendered=False,
                  show_spectrum=True, model_mask=None):
    """What :func:`show_sources` draws for each source but a
    ``NullSource``: (k, [(title, rgb, extent)], spectra) in order, the
    spectra None without ``show_spectrum``; numpy only, no matplotlib."""
    from .models.component import Component
    from .models.source import NullSource

    rows = []
    for k, src in enumerate(sources):
        if isinstance(src, NullSource):
            continue
        model_frame = src.frame
        model = to_numpy(src.get_model())
        panels = []
        if show_model:
            panels.append((f"Model Source {k}", img_to_rgb(
                model, norm=norm, channel_map=channel_map, mask=model_mask),
                get_extent(src.bbox)))
        if show_rendered:
            model_ = _render(observation,
                             to_numpy(src.get_model(frame=model_frame)))
            panels.append((f"Model Source {k} Rendered", img_to_rgb(
                model_, norm=norm, channel_map=channel_map),
                get_extent(observation.bbox)))
        if show_observed:
            panels.append(("Observation", img_to_rgb(
                observation.data, norm=norm, channel_map=channel_map),
                get_extent(observation.bbox)))
        spectra = None
        if show_spectrum:
            if hasattr(src, "__iter__") and len(src.children) and \
                    isinstance(src.children[0], Component):
                spectra = [to_numpy(c.get_model()).sum(axis=(1, 2))
                           for c in src.children]
            else:
                spectra = [model.sum(axis=(1, 2))]
        rows.append((k, panels, spectra))
    return rows


def show_sources(sources, observation=None, norm=None, channel_map=None,
                 show_model=True, show_observed=False, show_rendered=False,
                 show_spectrum=True, figsize=None, model_mask=None,
                 add_markers=True, add_boxes=False):
    """Per-source inspection panels. Ref: display.py:439-594."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon

    if show_observed or show_rendered:
        assert observation is not None, \
            "Provide matched observation to show observed frame"

    rows = source_panels(
        sources, observation, norm=norm, channel_map=channel_map,
        show_model=show_model, show_observed=show_observed,
        show_rendered=show_rendered, show_spectrum=show_spectrum,
        model_mask=model_mask)
    panels = sum((show_model, show_observed, show_rendered, show_spectrum))
    if figsize is None:
        figsize = (panel_size * panels, panel_size * len(rows))
    fig, ax = plt.subplots(len(rows), panels, figsize=figsize,
                           squeeze=False)

    marker_kwargs = {"mew": 1, "ms": 10}
    box_kwargs = {"facecolor": "none", "edgecolor": "w", "lw": 0.5}

    for row, (k, row_panels, spectra) in enumerate(rows):
        src = sources[k]
        model_frame = src.frame
        center = None
        if hasattr(src, "center") and src.center is not None:
            center = np.array(to_numpy(src.center))[::-1]

        if add_boxes:
            start = src.bbox.start[-2:][::-1]
            stop = src.bbox.stop[-2:][::-1]
            points = (start, (start[0], stop[1]), stop, (stop[0], start[1]))
            box_coords = [
                observation.get_pixel(model_frame.get_sky_coord(p))
                for p in points
            ]

        for panel, (title, rgb, extent) in enumerate(row_panels):
            a = ax[row][panel]
            a.imshow(rgb, extent=extent, origin="lower")
            a.set_title(title)
            model_panel = show_model and panel == 0
            if center is not None and add_markers:
                if model_panel:
                    a.plot(*center, "wx", **marker_kwargs)
                else:
                    center_ = observation.get_pixel(
                        model_frame.get_sky_coord(center))
                    a.plot(*center_, "wx", **marker_kwargs)
            if add_boxes and not model_panel:
                a.add_artist(Polygon(box_coords, closed=True, **box_kwargs))

        if spectra is not None:
            a = ax[row][len(row_panels)]
            for spectrum in spectra:
                a.plot(spectrum)
            a.set_xticks(range(len(spectrum)))
            if getattr(src.frame, "channels", None) is not None:
                a.set_xticklabels(src.frame.channels)
            a.set_title("Spectrum")
            a.set_xlabel("Channel")
            a.set_ylabel("Intensity")

    fig.tight_layout()
    return fig
