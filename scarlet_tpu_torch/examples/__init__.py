"""The JAX package's ten tutorial scripts (``examples/*.py``, the runnable
analog of the reference's tutorials) on the port, one module each:

    python -m scarlet_tpu_torch.examples.quickstart

Each module has ``load()``, which reads the file the JAX script reads,
under :data:`DATA_DIR` (``FileNotFoundError`` naming it when it is
absent); ``run(data, out_dir=".", fast=False, device=None)``, which does
the script's other steps in its order, computes each figure's RGB panels
and writes the figure (PNG, Agg) into ``out_dir`` where matplotlib is
installed (and says it draws none where it is not), prints its lines and
returns the printed numbers, the files written, the panels' shapes by
figure and the wall seconds by step; and ``main()``, which is
``run(load(), fast=bool(os.environ.get("SCARLET_TPU_FAST")))``.  ``fast``
takes the JAX script's ``SCARLET_TPU_FAST`` depths.  The fits run on the
CUDA card unless ``device="cpu"``; the steps the JAX script pins to the
host run on the CPU.  :mod:`scarlet_tpu_torch.testing.example_data` builds
a generated stand-in for each data file, which ``run()`` takes in place
of ``load()``'s dict.
"""
import pathlib

__all__ = ["DATA_DIR", "NAMES"]

# where the JAX package's examples read the reference's data files: the
# reference's data/ directory, checked out under the home directory
DATA_DIR = pathlib.Path.home() / "reference" / "data"

# in the order of the JAX package's README table
NAMES = ("quickstart", "display_tutorial", "point_source", "starlet_source",
         "lsbg_wavelet_model", "multiscale_deblending", "stream_deblending",
         "batched_deblending", "multiresolution", "hsc_hst_multires")
