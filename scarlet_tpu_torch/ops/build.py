"""Build and load the Hopper kernels of :mod:`scarlet_tpu_torch.ops.kernels`.

The CUDA sources in ``csrc/`` are compiled on first use with ``nvcc``, one
compiler process per source, all started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds).  The library is named
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
SOURCES = ("mono.cu", "wide.cu", "scene.cu", "grad.cu", "attrib.cu")
HEADERS = ("launch.cuh", "mono.cuh")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for name in SOURCES + HEADERS:
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
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
        objs = [os.path.join(tmpdir, name + ".o") for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *_FLAGS, "-c", "-o", obj, str(_CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        for name, proc, out in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} "
                                   f"({proc.returncode}):\n{out}")
        lib = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(lib, path)
    seconds = time.perf_counter() - t0
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
    # the projection kernels end with (T, P, ny, transposed, threads) of
    # kernels.mono_geometry and the stream
    geom = [i] * 5 + [p]
    lib.scarlet_mono_prox.argtypes = [p] * 6 + [i] * 5 + [ll] * 4 + \
        [i, f, f, p] + geom
    lib.scarlet_prox_chain.argtypes = [p] * 9 + [i] * 5 + [f] * 3 + geom
    lib.scarlet_fused_morph.argtypes = [p] * 12 + [i] * 6 + [f, i] + \
        [f] * 6 + [p] * 4 + geom
    lib.scarlet_mono_kernel_info.argtypes = [i] * 5 + [p]
    # the wide engine's entry points end with (T, P, ny, transposed, R,
    # rows, threads, smem) of kernels.wide_geometry, the workspace and the
    # stream
    wide = [i] * 8 + [p, p]
    lib.scarlet_wide_prox.argtypes = [p] * 6 + [i] * 5 + [ll] * 4 + \
        [i, f, f, p] + wide
    lib.scarlet_wide_chain.argtypes = [p] * 9 + [i] * 5 + [f] * 3 + wide
    lib.scarlet_wide_fused.argtypes = [p] * 12 + [i] * 6 + [f, i] + \
        [f] * 6 + [p] * 4 + wide
    lib.scarlet_wide_kernel_info.argtypes = [i] * 6 + [p]
    # the gather kernels end with the geometry of kernels.scene_geometry
    # (staged, XV, TX, TY, P, NG, CG, S, bands, tiles, threads, smem) and
    # grad_geometry (staged, G, groups, smem, R, tile rows, band group)
    lib.scarlet_scene_assembly.argtypes = [p] * 5 + [i] * 5 + [ll] + \
        [i] * 4 + [i] * 12 + [p]
    lib.scarlet_scene_kernel_info.argtypes = [i] * 5 + [p]
    lib.scarlet_grad_gather.argtypes = [p] * 6 + [i] * 8 + [ll] * 3 + \
        [i] * 7 + [p]
    lib.scarlet_grad_kernel_info.argtypes = [i, i, i, i, p]
    # T1 ends with (T, P, ny, transposed, threads) and the stream, as K1
    lib.scarlet_mono_pass_variant.argtypes = [p] * 5 + [i] * 5 + geom
    lib.scarlet_error_string.argtypes = [i]
    lib.scarlet_error_string.restype = ctypes.c_char_p
    for name in ("scarlet_mono_prox", "scarlet_mono_kernel_info",
                 "scarlet_wide_prox", "scarlet_wide_chain",
                 "scarlet_wide_fused", "scarlet_wide_kernel_info",
                 "scarlet_prox_chain", "scarlet_fused_morph",
                 "scarlet_scene_assembly", "scarlet_scene_kernel_info",
                 "scarlet_grad_gather", "scarlet_grad_kernel_info",
                 "scarlet_mono_pass_variant"):
        getattr(lib, name).restype = ctypes.c_int
    _lib = lib
    return lib


if __name__ == "__main__":
    out, secs, report = build(verbose=True)
    print(f"{out} built in {secs:.1f} s")
