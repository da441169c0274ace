"""Components: hyperspectral models anchored at a bounding box in the
model frame.  Port of ``scarlet_tpu/models/component.py``.

Behavioral reference: scarlet/component.py.
"""
from __future__ import annotations

import torch.nn.functional as F

from ..bbox import Box, overlapped_slices
from .constraint import PositivityConstraint
from .frame import Frame
from .model import Model, UpdateException
from .morphology import Morphology
from .parameter import Parameter, relative_step
from .spectrum import Spectrum

__all__ = ["Component", "FactorizedComponent", "CubeComponent",
           "CombinedComponent"]


class Component(Model):
    """Base component: a model tree node with a frame and a bbox.
    Ref: scarlet/component.py:13-116."""

    def __init__(self, frame, *parameters, children=None, bbox=None):
        assert isinstance(frame, Frame)
        if bbox is None:
            bbox = frame.bbox
        assert isinstance(bbox, Box)
        self._bbox = bbox
        self.frame = frame
        super().__init__(*parameters, children=children)

    @property
    def bbox(self):
        return self._bbox

    @bbox.setter
    def bbox(self, b):
        if b is None:
            b = self._frame.bbox
        self._bbox = b
        self._model_frame_slices, self._model_slices = overlapped_slices(
            self._frame.bbox, self._bbox)

    @property
    def frame(self):
        return self._frame

    @frame.setter
    def frame(self, f):
        self._frame = f
        self._model_frame_slices, self._model_slices = overlapped_slices(
            self._frame.bbox, self._bbox)

    def model_to_box(self, bbox=None, model=None):
        """Zero-embed the boxed model into ``bbox`` (default: the frame).
        Ref: component.py:83-116."""
        if model is None:
            model = self.get_model()
        if bbox is None or bbox == self.frame.bbox:
            bbox = self.frame.bbox
            frame_slices = self._model_frame_slices
            model_slices = self._model_slices
        else:
            frame_slices, model_slices = overlapped_slices(bbox, self.bbox)

        result = model.new_zeros(bbox.shape)
        result[frame_slices] = model[model_slices]
        return result


class FactorizedComponent(Component):
    """spectrum (C,) x morphology (H, W) outer product.
    Ref: scarlet/component.py:119-193."""

    def __init__(self, frame, spectrum, morphology):
        assert isinstance(spectrum, Spectrum)
        assert isinstance(morphology, Morphology)
        bbox = spectrum.bbox @ morphology.bbox[-2:]
        super().__init__(frame, children=[spectrum, morphology], bbox=bbox)

    def get_model(self, *parameters, frame=None):
        spectrum, morphology = self.get_models_of_children(*parameters)
        if morphology.ndim == 2:
            model = spectrum[:, None, None] * morphology[None, :, :]
        elif morphology.ndim == 3:
            model = spectrum[:, None, None] * morphology
        else:
            raise AttributeError("morphology must be 2D or 3D")
        if frame is not None:
            model = self.model_to_box(frame.bbox, model)
        return model

    def update(self):
        for child in self.children:
            try:
                child.update()
            except UpdateException as e:
                spectrum, morphology = self.children
                self.bbox = spectrum.bbox @ morphology.bbox[-2:]
                raise e

    @property
    def spectrum(self):
        return self.children[0]

    @property
    def morphology(self):
        return self.children[1]


class CubeComponent(Component):
    """Free (C, H, W) hyperspectral cube. Ref: scarlet/component.py:196-226."""

    def __init__(self, frame, cube, bbox=None):
        if isinstance(cube, Parameter):
            assert cube.name == "cube"
        else:
            cube = Parameter(cube, name="cube", step=relative_step,
                             constraint=PositivityConstraint())
        super().__init__(frame, cube, bbox=bbox)

    def get_model(self, *parameters, frame=None):
        model = self.get_parameter(0, *parameters)
        if frame is not None:
            model = self.model_to_box(frame.bbox, model)
        return model


class CombinedComponent(Component):
    """Add or multiply child components over the union box.
    Ref: scarlet/component.py:229-290."""

    def __init__(self, components, operation="add"):
        assert len(components)
        frame = components[0].frame
        box = components[0].bbox
        for c in components:
            assert isinstance(c, Component)
            assert c.frame is frame
        super().__init__(frame, children=components, bbox=box)
        assert operation in ("add", "multiply")
        self.operation = operation

    def get_model(self, *parameters, frame=None):
        models = self.get_models_of_children(*parameters, frame=None)
        bbox = self.bbox
        model = models[0].new_zeros(bbox.shape)
        for k, model_ in enumerate(models):
            c = self.children[k]
            if c.bbox != bbox:
                # F.pad takes (before, after) pairs from the last axis
                pad = []
                for d in reversed(range(bbox.D)):
                    pad += [c.bbox.start[d] - bbox.start[d],
                            bbox.stop[d] - c.bbox.stop[d]]
                model_ = F.pad(model_, pad)
            if self.operation == "add":
                model = model + model_
            else:
                model = model * model_
        if frame is not None:
            model = self.model_to_box(frame.bbox, model)
        return model

    def update(self):
        for child in self.children:
            try:
                child.update()
            except UpdateException as e:
                box = self.children[0].bbox.copy()
                for c in self.children[1:]:
                    box = box | c.bbox
                self.bbox = box
                raise e

