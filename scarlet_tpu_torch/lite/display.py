"""Lite visualization: blend-level scene/source panels and spectrum
comparison.  Port of ``scarlet_tpu/lite/display.py``; tensors become
numpy arrays at the drawing boundary (:func:`.utils.to_numpy`), and a
model is rendered on the observation's device in float64, as
:mod:`scarlet_tpu_torch.display` does.

Behavioral reference: scarlet/lite/display.py.
"""
from __future__ import annotations

import numpy as np

from ..display import (  # noqa: F401
    panel_size,
    channels_to_rgb,
    LinearPercentileNorm,
    AsinhPercentileNorm,
    img_to_3channel,
    img_to_rgb,
    get_extent,
    _mask,
    _render,
)
from .utils import to_numpy

__all__ = ["show_scene", "show_sources", "compare_spectra"]


def _add_markers(src, extent, ax, add_markers, add_boxes, marker_kwargs,
                 box_kwargs):
    """Ref: lite/display.py:8-21."""
    from matplotlib.patches import Rectangle

    if add_markers and hasattr(src, "center") and src.center is not None:
        center = np.array(src.center)[::-1]
        ax.plot(*center, "wx", **marker_kwargs)
    if add_boxes:
        rect = Rectangle(
            (extent[0], extent[2]),
            extent[1] - extent[0],
            extent[3] - extent[2],
            **box_kwargs)
        ax.add_artist(rect)


def show_scene(blend, norm=None, channel_map=None, show_model=True,
               show_observed=False, show_rendered=False, show_residual=False,
               add_labels=True, add_boxes=False, figsize=None, linear=True,
               use_flux=False, box_kwargs=None):
    """Model/observed/rendered/residual panels for a LiteBlend.

    Ref: lite/display.py:24-181.
    """
    import matplotlib.pyplot as plt

    if box_kwargs is None:
        box_kwargs = {"facecolor": "none", "edgecolor": "w", "lw": 0.5}

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

    observation = blend.observation
    sources = blend.sources
    model = to_numpy(blend.get_model(use_flux=use_flux))
    bbox = blend.bbox
    mask = _mask(observation)

    panel = 0
    if show_model:
        extent = get_extent(bbox)
        ax[panel].imshow(
            img_to_rgb(model, norm=norm, channel_map=channel_map, mask=mask),
            extent=extent, origin="lower")
        ax[panel].set_title("Model")
        panel += 1

    if (show_rendered or show_residual) and not use_flux:
        model = _render(observation, model)
    extent = get_extent(observation.bbox)

    if show_rendered:
        ax[panel].imshow(
            img_to_rgb(model, norm=norm, channel_map=channel_map, mask=mask),
            extent=extent, origin="lower")
        ax[panel].set_title("Model Rendered")
        panel += 1

    if show_observed:
        ax[panel].imshow(
            img_to_rgb(observation.images, norm=norm, channel_map=channel_map,
                       mask=mask),
            extent=extent, origin="lower")
        ax[panel].set_title("Observation")
        panel += 1

    if show_residual:
        residual = to_numpy(observation.images) - model
        norm_ = LinearPercentileNorm(residual)
        ax[panel].imshow(
            img_to_rgb(residual, norm=norm_, channel_map=channel_map,
                       mask=mask),
            extent=extent, origin="lower")
        ax[panel].set_title("Residual")
        panel += 1

    for k, src in enumerate(sources):
        if add_labels and hasattr(src, "center") and src.center is not None:
            center = src.center
            for p in range(panels):
                ax[p].text(*center[::-1], k, color="w", ha="center",
                           va="center")
        if add_boxes and not src.is_null:
            extent_src = get_extent(src.bbox[-2:])
            for p in range(panels):
                _add_markers(src, extent_src, ax[p], False, True, {},
                             box_kwargs)

    fig.tight_layout()
    return fig


def show_sources(blend, sources=None, norm=None, channel_map=None,
                 show_model=True, show_observed=False, show_rendered=False,
                 show_spectrum=True, figsize=None, model_mask=None,
                 add_markers=True, add_boxes=False, use_flux=False):
    """Per-source panels for a LiteBlend. Ref: lite/display.py:184-278."""
    import matplotlib.pyplot as plt

    if sources is None:
        sources = blend.sources
    observation = blend.observation

    panels = sum((show_model, show_observed, show_rendered, show_spectrum))
    n_sources = len([s for s in sources if not s.is_null])
    if figsize is None:
        figsize = (panel_size * panels, panel_size * n_sources)
    fig, ax = plt.subplots(n_sources, panels, figsize=figsize, squeeze=False)

    marker_kwargs = {"mew": 1, "ms": 10}
    box_kwargs = {"facecolor": "none", "edgecolor": "w", "lw": 0.5}

    skipped = 0
    for k, src in enumerate(sources):
        if src.is_null:
            skipped += 1
            continue
        row = k - skipped
        panel = 0
        model = to_numpy(src.get_model(use_flux=use_flux))
        bbox = src.flux_box if use_flux and src.flux_box is not None \
            else src.bbox
        extent = get_extent(bbox[-2:])

        if show_model:
            ax[row][panel].imshow(
                img_to_rgb(model, norm=norm, channel_map=channel_map,
                           mask=model_mask),
                extent=extent, origin="lower")
            ax[row][panel].set_title(f"Model Source {k}")
            _add_markers(src, extent, ax[row][panel], add_markers, add_boxes,
                         marker_kwargs, box_kwargs)
            panel += 1

        if show_rendered:
            full = to_numpy(src.get_model(bbox=observation.bbox,
                                          use_flux=use_flux))
            if not use_flux:
                full = _render(observation, full)
            ax[row][panel].imshow(
                img_to_rgb(full, norm=norm, channel_map=channel_map),
                extent=get_extent(observation.bbox), origin="lower")
            ax[row][panel].set_title(f"Model Source {k} Rendered")
            _add_markers(src, extent, ax[row][panel], add_markers, add_boxes,
                         marker_kwargs, box_kwargs)
            panel += 1

        if show_observed:
            ax[row][panel].imshow(
                img_to_rgb(observation.images, norm=norm,
                           channel_map=channel_map),
                extent=get_extent(observation.bbox), origin="lower")
            ax[row][panel].set_title("Observation")
            _add_markers(src, extent, ax[row][panel], add_markers, add_boxes,
                         marker_kwargs, box_kwargs)
            panel += 1

        if show_spectrum:
            spectra = [to_numpy(c.get_model()).sum(axis=(1, 2))
                       for c in src.components]
            for spectrum in spectra:
                ax[row][panel].plot(spectrum)
            ax[row][panel].set_title("Spectrum")
            ax[row][panel].set_xlabel("Channel")
            ax[row][panel].set_ylabel("Intensity")

    fig.tight_layout()
    return fig


def compare_spectra(use_flux=True, use_template=True, **all_sources):
    """Compare spectra from multiple deblending runs of the same sources.

    Ref: lite/display.py:281-326.
    """
    import matplotlib.pyplot as plt

    first_key = next(iter(all_sources.keys()))
    K = len(all_sources[first_key])
    for key, sources in all_sources.items():
        if len(sources) != K:
            raise ValueError(
                "All source lists must have the same number of components. "
                f"Received {K} sources for {first_key} and {len(sources)} "
                f"for {key}.")

    columns = min(K, 4)
    rows = int(np.ceil(K / columns))
    fig, ax = plt.subplots(rows, columns, figsize=(15, 15 * rows / columns),
                           squeeze=False)

    for k in range(K):
        row, column = k // columns, k % columns
        ax[row][column].set_title(f"source {k}")
        for key, sources in all_sources.items():
            if sources[k].is_null:
                continue
            if use_template or sources[k].flux is None:
                sed = np.sum(to_numpy(sources[k].get_model()), axis=(1, 2))
                ax[row][column].plot(sed, ".-", label=key + " model")
            if use_flux and sources[k].flux is not None:
                sed = np.sum(to_numpy(sources[k].get_model(use_flux=True)),
                             axis=(1, 2))
                ax[row][column].plot(sed, ".--", label=key + " flux")
    handles, labels = ax[0][0].get_legend_handles_labels()
    fig.legend(handles, labels, loc="lower center", ncol=4)
    return fig
