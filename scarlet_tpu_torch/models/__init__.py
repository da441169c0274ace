"""The model tree: parameters, constraints, priors, frames, observations,
PSFs, renderers, spectra, morphologies, components, sources and the
blend with its fit."""
from .parameter import Parameter, prepare_param, relative_step  # noqa: F401
from .model import Model, UpdateException  # noqa: F401
from .prior import Prior  # noqa: F401
from .constraint import (  # noqa: F401
    Constraint,
    ConstraintChain,
    PositivityConstraint,
    NormalizationConstraint,
    L0Constraint,
    L1Constraint,
    ThresholdConstraint,
    MonotonicityConstraint,
    MonotonicMaskConstraint,
    SymmetryConstraint,
    CenterOnConstraint,
    LeakyConstraint,
)
from .psf import (  # noqa: F401
    PSF, FunctionPSF, GaussianPSF, MoffatPSF, ImagePSF, normalize)
from .frame import Frame  # noqa: F401
from .renderer import Renderer, NullRenderer, ConvolutionRenderer  # noqa: F401
from .resolution import ResolutionRenderer  # noqa: F401
from .observation import Observation  # noqa: F401
from .spectrum import Spectrum, TabulatedSpectrum  # noqa: F401
from .morphology import (  # noqa: F401
    Morphology,
    ImageMorphology,
    ProfileMorphology,
    GaussianMorphology,
    SpergelMorphology,
    PointSourceMorphology,
    StarletMorphology,
    ExtendedSourceMorphology,
)
from .component import (  # noqa: F401
    Component,
    FactorizedComponent,
    CubeComponent,
    CombinedComponent,
)
from .source import (  # noqa: F401
    NullSource,
    RandomSource,
    PointSource,
    GaussianSource,
    SpergelSource,
    CompactExtendedSource,
    SingleExtendedSource,
    MultiExtendedSource,
    StarletSource,
    ExtendedSource,
)
from .blend import Blend  # noqa: F401
