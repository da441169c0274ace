"""Local-filesystem result store (scarlet_tpu/testing/store.py, which
replaces the reference's AWS DynamoDB/S3 backend,
scarlet/testing/aws.py:17-117): JSON records keyed by branch under
``.regression/``, residual images as npz.  The same layout and JSON as
the JAX package's, so either package reads what the other wrote."""
from __future__ import annotations

import json
import pathlib
import subprocess
import time

import numpy as np

from .blendsets import default_root

__all__ = ["save_records", "load_records", "save_residuals", "default_root"]


def _branch():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--abbrev-ref", "HEAD"],
            capture_output=True, text=True, check=True
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def save_records(records, set_id, branch=None, root=None):
    """Append measurement records for a blend set; returns the file path."""
    root = pathlib.Path(root) if root else default_root()
    branch = branch or _branch()
    path = root / branch
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"set{set_id}.json"
    existing = []
    if out.exists():
        existing = json.loads(out.read_text())
    existing.append({
        "timestamp": time.time(),
        "records": records,
    })
    out.write_text(json.dumps(existing, indent=1, default=float))
    return out


def load_records(set_id, branch=None, root=None):
    root = pathlib.Path(root) if root else default_root()
    branch = branch or _branch()
    out = root / branch / f"set{set_id}.json"
    if not out.exists():
        return []
    return json.loads(out.read_text())


def save_residuals(images, model, set_id, blend_id, branch=None, root=None):
    """Store the residual cube for later inspection (S3 analog)."""
    root = pathlib.Path(root) if root else default_root()
    branch = branch or _branch()
    path = root / branch / "residuals"
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"set{set_id}_blend{blend_id}.npz"
    np.savez_compressed(out, residual=np.asarray(images) - np.asarray(model))
    return out
