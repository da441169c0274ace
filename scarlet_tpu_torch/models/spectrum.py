"""Spectrum models: the 1D spectral factors of factorized components.
Port of ``scarlet_tpu/models/spectrum.py``.

Behavioral reference: scarlet/spectrum.py.
"""
from __future__ import annotations

from functools import partial

from ..bbox import Box
from .constraint import PositivityConstraint
from .frame import Frame
from .model import Model
from .parameter import Parameter, relative_step

__all__ = ["Spectrum", "TabulatedSpectrum"]


class Spectrum(Model):
    """Base class. Ref: scarlet/spectrum.py:10-29."""

    def __init__(self, frame, *parameters, bbox=None):
        assert isinstance(frame, Frame)
        self.frame = frame
        assert isinstance(bbox, Box)
        self.bbox = bbox
        super().__init__(*parameters)


class TabulatedSpectrum(Spectrum):
    """Free positive per-channel amplitudes with 1% relative steps floored
    by the noise RMS.  Ref: scarlet/spectrum.py:32-71.
    """

    def __init__(self, frame, spectrum, bbox=None, min_step=0):
        if isinstance(spectrum, Parameter):
            assert spectrum.name == "spectrum"
        else:
            constraint = PositivityConstraint(zero=1e-20)
            step = partial(relative_step, factor=1e-2, minimum=min_step)
            spectrum = Parameter(spectrum, name="spectrum", step=step,
                                 constraint=constraint)

        if bbox is None:
            assert frame.bbox[0].shape == spectrum.shape
            bbox = Box(spectrum.shape)
        else:
            assert bbox.shape == spectrum.shape

        super().__init__(frame, spectrum, bbox=bbox)

    def get_model(self, *parameters):
        return self.get_parameter(0, *parameters)
