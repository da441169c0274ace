"""Build the host C library of :mod:`scarlet_tpu_torch.native`.

``kernels.cc`` beside this file is compiled on first use with the host
C++ compiler (``$CXX``, else ``g++``) into one shared library with a plain
C interface, loaded with ``ctypes``.  The flags are ``-O3 -std=c++17
-shared -fPIC -ffp-contract=off``:

- ``-ffp-contract=off``: no multiply-add is fused, so every product and
  every sum rounds on its own, as in the numpy twins, the Jacobi
  projection and K1 on the card; the sequential sweep then equals them
  bit for bit on any CPU (a fused build parts from them by an ulp).
- no ``-march=native``: the library runs on any CPU of its architecture.

The library is named by a hash of the source, the flags and the
compiler's ``--version`` and lives in ``_build/`` beside this file (or in
``$SCARLET_NATIVE_BUILD_DIR``); it is written to a temporary file that is
renamed into place, so processes that build it at once (test workers,
the pipeline's CPU workers) never load a half-written file.  A missing
compiler or a failed build raises with the compiler's log.

Run ``python -m scarlet_tpu_torch.native.build`` to build it.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = ["SOURCE", "FLAGS", "cxx_path", "build_dir", "library_path",
           "build"]

_HERE = pathlib.Path(__file__).parent
SOURCE = _HERE / "kernels.cc"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def cxx_path():
    """The host C++ compiler: ``$CXX`` when it is set (a path or a name
    on ``PATH``), else ``g++`` on ``PATH`` or ``/usr/bin/g++``."""
    env = os.environ.get("CXX")
    if env:
        found = shutil.which(env)
        if found is None:
            raise RuntimeError(f"C++ compiler $CXX={env!r} not found")
        return found
    for c in (shutil.which("g++"), "/usr/bin/g++"):
        if c and pathlib.Path(c).exists():
            return c
    raise RuntimeError("C++ compiler not found (set CXX or put g++ on "
                       "PATH)")


def build_dir():
    return pathlib.Path(os.environ.get("SCARLET_NATIVE_BUILD_DIR",
                                       _HERE / "_build"))


def _version(cxx):
    proc = subprocess.run([cxx, "--version"], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def library_path(cxx=None):
    cxx = cxx or cxx_path()
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_version(cxx).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"libscarlet_native_{h.hexdigest()[:16]}.so"


def build(verbose=False):
    """Compile ``kernels.cc`` unless the library for this source, these
    flags and this compiler exists.  Returns ``(path, seconds, compiler,
    compiler_log)``; seconds is 0.0 and the log empty when nothing was
    built."""
    cxx = cxx_path()
    path = library_path(cxx)
    if path.exists():
        return path, 0.0, cxx, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        lib = os.path.join(tmpdir, "lib.so")
        cmd = [cxx, *FLAGS, "-o", lib, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0 or not os.path.exists(lib):
            raise RuntimeError(f"{' '.join(cmd)} failed "
                               f"({proc.returncode}):\n{log}")
        os.replace(lib, path)
    seconds = time.perf_counter() - t0
    if verbose:
        print(" ".join(cmd))
        print(log, end="")
    return path, seconds, cxx, log


if __name__ == "__main__":
    out, secs, compiler, _ = build(verbose=True)
    print(f"{out} built in {secs:.2f} s by {compiler}")
