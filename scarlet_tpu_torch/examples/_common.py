"""What the example modules share: the data path check, the figures (their
RGB panels always, the drawing where matplotlib is installed), the output
paths and the wall clock of a run's steps."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import default_device
from . import DATA_DIR


def data_path(name):
    """The reference data file ``name`` under ``DATA_DIR``;
    ``FileNotFoundError`` naming it when it is absent."""
    path = DATA_DIR / name
    if not path.exists():
        raise FileNotFoundError(
            f"{path}: the reference's data file is not present (pass a "
            f"stand-in from scarlet_tpu_torch.testing.example_data to "
            f"run() instead)")
    return path


def load_npz(name):
    """The arrays of the npz file ``name`` (pickled records allowed)."""
    with np.load(data_path(name), allow_pickle=True) as f:
        return {k: f[k] for k in f.files}


def pyplot():
    """matplotlib's pyplot on the Agg backend (figures go to files), or
    None where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# the keywords of the display's figure functions that only draw; the
# panel function of each takes the others
_DRAW_ONLY = ("add_labels", "add_boxes", "add_markers", "figsize", "linear",
              "sky_coords")


def figure_panels(show, *args, **kwargs):
    """The RGB arrays that the figure function ``show`` of
    :mod:`scarlet_tpu_torch.display` draws for ``(*args, **kwargs)``, from
    its panel function (numpy only); none for ``show_likelihood``'s line
    plot."""
    from .. import display

    if show is display.show_likelihood:
        return []
    kwargs = {k: v for k, v in kwargs.items() if k not in _DRAW_ONLY}
    if show is display.show_sources:
        return [rgb for _, row, _ in display.source_panels(*args, **kwargs)
                for _, rgb, _ in row]
    panels = {display.show_scene: display.scene_panels,
              display.show_observation: display.observation_panels}[show]
    return [rgb for _, rgb, _ in panels(*args, **kwargs)]


def fast_env():
    return bool(os.environ.get("SCARLET_TPU_FAST"))


class Run:
    """A run's device (the card unless ``device`` says otherwise), output
    directory, files written and wall seconds by step (host clock after
    a device synchronize)."""

    def __init__(self, out_dir, device):
        self.device = default_device(device)
        self.out_dir = os.fspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.files = []
        self.panels = {}
        self.seconds = {}
        self._plt = None
        self._t = time.perf_counter()

    def path(self, name):
        """The path of output file ``name``, recorded as written."""
        self.files.append(name)
        return os.path.join(self.out_dir, name)

    def figure(self, name, rgbs, draw, dpi):
        """Figure ``name``: its RGB panels ``rgbs`` (the display's numerics,
        computed by the caller with or without matplotlib) are recorded by
        shape; where matplotlib is installed, the figure ``draw(plt)``
        returns is written to output file ``name`` and closed."""
        self.panels[name] = [tuple(np.shape(rgb)) for rgb in rgbs]
        if self._plt is None:
            self._plt = pyplot() or False
            if not self._plt:
                print("matplotlib is not installed: the figures' panels are "
                      "computed and none is drawn")
        if self._plt:
            fig = draw(self._plt)
            fig.savefig(self.path(name), dpi=dpi)
            self._plt.close(fig)
            print(f"wrote {name}")

    def show(self, name, show, *args, dpi, **kwargs):
        """:meth:`figure` ``name`` of the display's figure function
        ``show(*args, **kwargs)``."""
        self.figure(name, figure_panels(show, *args, **kwargs),
                    lambda plt: show(*args, **kwargs), dpi)

    def lap(self, step):
        """Add the seconds since the last lap to ``step``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[step] = self.seconds.get(step, 0.0) + now - self._t
        self._t = now

    def result(self, **numbers):
        return dict(numbers, files=list(self.files),
                    panels=dict(self.panels), seconds=dict(self.seconds))
