"""The model tree's base node.  Port of ``scarlet_tpu/models/model.py``:
a :class:`Model` owns :class:`~.parameter.Parameter` objects and child
models; ``get_model(*parameters)`` evaluates the node with the stored
values or with a flat tuple of tensors (autograd flows through those).
``update()`` adjusts a model between fit segments and raises
:class:`UpdateException` to restart the optimizer."""
from __future__ import annotations

from .parameter import Parameter

__all__ = ["Model", "UpdateException"]


class UpdateException(Exception):
    """Raised by ``Model.update()`` to interrupt and restart the optimizer
    (e.g. after a box resize).  Ref: scarlet/model.py:7-8."""


class Model:
    """Base class of the model tree. Ref: scarlet/model.py:11-177."""

    def __init__(self, *parameters, children=None):
        for p in parameters:
            assert isinstance(p, Parameter), f"got {type(p)}"
        self._parameters = tuple(parameters)

        if children is None:
            children = ()
        if hasattr(children, "__iter__"):
            for c in children:
                assert isinstance(c, Model)
            self._children = tuple(children)
        else:
            assert isinstance(children, Model)
            self._children = (children,)

        self.check_parameters()

    @property
    def parameters(self):
        """Flat tuple of own parameters followed by all children's."""
        return self._parameters + tuple(
            p for c in self._children for p in c.parameters
        )

    @property
    def children(self):
        return self._children

    def __getitem__(self, i):
        return self._children[i]

    def __iter__(self):
        return iter(self._children)

    def get_parameter(self, i, *parameters):
        """Parameter lookup by index, slice, or name: the matching value(s)
        of ``parameters`` when given, else of the stored parameters.  A
        name resolves against the stored parameters' names.
        Ref: scarlet/model.py:71-110.
        """
        own = self.parameters
        values = parameters if parameters else tuple(p.value for p in own)

        if isinstance(i, (int, slice)):
            return values[i]
        if isinstance(i, str):
            idx = [k for k, p in enumerate(own) if p.name == i]
            if len(idx) == 0:
                return None
            if len(idx) == 1:
                return values[idx[0]]
            return tuple(values[k] for k in idx)
        return None

    def get_model(self, *parameters, **kwargs):
        raise NotImplementedError

    def get_models_of_children(self, *parameters, **kwargs):
        """Evaluate all children, handing each its slice of
        ``parameters``.  Ref: scarlet/model.py:127-151."""
        models = []
        if len(parameters):
            i = len(self._parameters)
            for c in self._children:
                j = len(c.parameters)
                models.append(c.get_model(*parameters[i:i + j], **kwargs))
                i += j
        else:
            for c in self._children:
                models.append(c.get_model(**kwargs))
        return models

    def check_parameters(self):
        """Raise ``ArithmeticError`` on non-finite parameters.
        Ref: scarlet/model.py:153-165."""
        for p in self.parameters:
            if not p.is_finite:
                raise ArithmeticError(
                    f"Model {self.__class__.__name__}, parameter '{p.name}' "
                    f"is not finite:\n{p.value}"
                )

    def update(self):
        """Adjust model state outside the optimization forward path; raise
        :class:`UpdateException` to interrupt the optimizer.
        Ref: scarlet/model.py:167-177.
        """
