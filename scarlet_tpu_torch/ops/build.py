"""Build and load the Hopper kernels of :mod:`scarlet_tpu_torch.ops.kernels`.

The CUDA sources in ``csrc/`` are compiled on first use with ``nvcc`` into
one shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds).  The library is named
by a hash of the sources and flags and lives in ``_build/`` beside this
file, so a changed source rebuilds and a concurrent build never sees a
half-written file.

Run ``python -m scarlet_tpu_torch.ops.build`` to build and print the
compiler's register and shared-memory report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["SOURCES", "nvcc_path", "library_path", "build", "load"]

_HERE = pathlib.Path(__file__).parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
SOURCES = ("mono.cu", "scene.cu", "grad.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``,
    or ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(pathlib.Path(found))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD / f"libscarlet_kernels_{h.hexdigest()[:16]}.so"


def build(verbose=False):
    """Compile the kernels unless the library for these sources exists.
    Returns ``(path, seconds, compiler_log)``; seconds is 0.0 and the log
    empty when nothing was built."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [nvcc_path(), *_FLAGS, "-o", tmp,
           *(str(_CSRC / name) for name in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if verbose:
        print(log)
    return path, seconds, log


def load():
    """Build if needed, load the library and declare its entry points."""
    global _lib
    if _lib is not None:
        return _lib
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.scarlet_mono_prox.argtypes = [p, p, p, p, p, i, i, i, i, i, ll, ll,
                                      ll, ll, i, f, f, p]
    lib.scarlet_mono_smem_bytes.argtypes = [i, i]
    lib.scarlet_scene_assembly.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, p]
    lib.scarlet_grad_gather.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, p]
    lib.scarlet_grad_max_bands.argtypes = []
    lib.scarlet_error_string.argtypes = [i]
    lib.scarlet_error_string.restype = ctypes.c_char_p
    for name in ("scarlet_mono_prox", "scarlet_mono_smem_bytes",
                 "scarlet_scene_assembly", "scarlet_grad_gather",
                 "scarlet_grad_max_bands"):
        getattr(lib, name).restype = ctypes.c_int
    _lib = lib
    return lib


if __name__ == "__main__":
    out, secs, report = build(verbose=True)
    print(f"{out} built in {secs:.1f} s")
