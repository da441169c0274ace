"""scarlet_tpu_torch: the lite deblender and the batched multi-resolution
fitter of ``scarlet_tpu`` in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (H100).

The JAX package ``scarlet_tpu`` is the reference this port is tested
against; this package imports neither it nor JAX.  On CPU tensors every
kernel runs as its plain PyTorch version; on CUDA tensors the kernels of
:mod:`scarlet_tpu_torch.ops.kernels` are compiled with ``nvcc`` on first
use.

Main path::

    obs = lite.LiteObservation(images, variance, weights, psfs, model_psf)
    sources = lite.init_all_sources_main(obs, centers)
    sources = lite.parameterize_sources(sources, obs,
                                        lite.init_adaprox_component)
    lite.LiteBlend(sources, obs).fit(100, device="cuda")
    # or many blends at once:
    config, data, state = parallel.pack_blends(blends, device="cuda")
    state, losses = parallel.fit_batch_device_converged(
        state, data, config, 100, check_every=25)
    # or raw (B, C, H, W) stacks and catalogs, initialized on the device:
    records, state, losses, aux = parallel.deblend_device_stream(
        images, variance, psfs, centers, model_psf, box_size=59,
        n_slots=16, chunk=128, compact=50, device="cuda")
    # several instruments at different resolutions (models.Observation
    # with a WCS each, models.Frame.from_observations):
    fitter = parallel.MultiResFitter(observations, box_size=31)
    # a batch split over the ranks of a torch.distributed group, on a
    # ("blends", "bands") grid (one card per rank, or the CPU over gloo):
    mesh = parallel.make_mesh(bands=2)
    state, losses = parallel.fit_batch_sharded(
        state, data, config, 100, mesh, shard_bands=True)

The object tree (scarlet's quickstart), under the reference's top-level
names (``import scarlet_tpu_torch as st``)::

    frame = st.Frame(images.shape, channels, psf=st.GaussianPSF(0.8))
    obs = st.Observation(images, channels, psf=st.ImagePSF(psfs),
                         weights=weights).match(frame)
    sources, skipped = st.initialization.init_all_sources(
        frame, centers, obs, max_components=2, min_snr=30, silent=True)
    st.Blend(sources, obs).fit(100, e_rel=1e-4)
    fluxes = [st.measure.flux(s) for s in sources]

The top level holds the reference's names (the model tree, ``Box``,
``Cache``, ``Starlet``) and its module namespaces but ``display``, which
is not ported yet.  Importing the package builds no kernel.
"""
from .bbox import Box, overlapped_slices  # noqa: F401
from .cache import Cache  # noqa: F401
from . import ops  # noqa: F401
from .ops.wavelet import Starlet  # noqa: F401
from . import initialization  # noqa: F401
from . import detect  # noqa: F401
from . import optim  # noqa: F401
from . import lite  # noqa: F401
from .models import (  # noqa: F401
    Parameter,
    prepare_param,
    relative_step,
    Model,
    UpdateException,
    Prior,
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
    PSF,
    FunctionPSF,
    GaussianPSF,
    MoffatPSF,
    ImagePSF,
    Frame,
    Renderer,
    NullRenderer,
    ConvolutionRenderer,
    ResolutionRenderer,
    Observation,
    Spectrum,
    TabulatedSpectrum,
    Morphology,
    ImageMorphology,
    ProfileMorphology,
    GaussianMorphology,
    SpergelMorphology,
    PointSourceMorphology,
    StarletMorphology,
    ExtendedSourceMorphology,
    Component,
    FactorizedComponent,
    CubeComponent,
    CombinedComponent,
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
    Blend,
)
from . import measure  # noqa: F401
from . import operator  # noqa: F401
from . import testing  # noqa: F401
from . import models, parallel, utils  # noqa: F401

__version__ = "0.1.0"
