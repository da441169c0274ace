"""The model tree's frames, observations, PSFs and renderers (what the
multi-resolution fit uses), with the parameter helpers of the lite path."""
from .parameter import Parameter, prepare_param, relative_step  # noqa: F401
from .model import Model  # noqa: F401
from .psf import (  # noqa: F401
    PSF, FunctionPSF, GaussianPSF, MoffatPSF, ImagePSF, normalize)
from .frame import Frame  # noqa: F401
from .renderer import Renderer, NullRenderer, ConvolutionRenderer  # noqa: F401
from .resolution import ResolutionRenderer  # noqa: F401
from .observation import Observation  # noqa: F401
