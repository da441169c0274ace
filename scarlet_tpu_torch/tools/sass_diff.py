"""Whether two checkouts compile a kernel source to the same machine code.

Each root's ``scarlet_tpu_torch/ops/csrc/<source>`` (with its own
headers) is compiled by nvcc with the build's flags
(``ops.build``) to a Hopper cubin, disassembled by ``cuobjdump -sass``,
and compared kernel by kernel, the instructions with their encodings.
Identical machine code runs the same instructions on the same data, so
it gives the same bits at the same speed.

Run from a checkout's root on a machine with the CUDA toolkit (no card
is needed)::

    python -m scarlet_tpu_torch.tools.sass_diff --roots PARENT_DIR .
        [--sources mono.cu wide.cu]

Prints one JSON line: per source, the kernels compared, those that
differ or are missing from one root, and whether all are the same.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile

from ..ops import build

CSRC = pathlib.Path("scarlet_tpu_torch") / "ops" / "csrc"


def sass(root, source, cubin):
    """{kernel name: its SASS text} of ``source`` in checkout ``root``,
    compiled to the file ``cubin``."""
    nvcc = build.nvcc_path()
    flags = [f for f in build._FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                    str(pathlib.Path(root) / CSRC / source)], check=True,
                   capture_output=True)
    text = subprocess.run(
        [str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout
    # the anonymous namespace's name carries a hash of its file
    text = re.sub(r"_cu_[0-9a-f]{8}", "_cu_",
                  re.sub(r"_GLOBAL__N__[0-9a-f]+", "_GLOBAL__N__", text))
    kernels, name = {}, None
    for line in text.splitlines():
        if line.strip().startswith("Function : "):
            name = line.split("Function : ", 1)[1].strip()
            kernels[name] = []
        elif name is not None:
            kernels[name].append(line.strip())
    return {k: "\n".join(v) for k, v in kernels.items()}


def compare(roots, sources):
    out = {}
    with tempfile.TemporaryDirectory() as work:
        for source in sources:
            a, b = (sass(root, source,
                         pathlib.Path(work) / f"{i}_{source}.cubin")
                    for i, root in enumerate(roots))
            differ = sorted(k for k in set(a) & set(b) if a[k] != b[k])
            missing = sorted(set(a) ^ set(b))
            out[source] = dict(kernels=len(set(a) | set(b)), differ=differ,
                               missing=missing,
                               same=not differ and not missing)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs=2, required=True)
    ap.add_argument("--sources", nargs="*", default=["mono.cu", "wide.cu"])
    args = ap.parse_args(argv)
    report = compare(args.roots, args.sources)
    print(json.dumps(dict(roots=args.roots, sources=report)))
    return 0 if all(r["same"] for r in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
