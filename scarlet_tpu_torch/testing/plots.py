"""Regression dashboards: per-metric distribution plots from the local
store (scarlet_tpu/testing/plots.py).

Ref: scarlet/testing/measure.py:124-231 — the reference renders
violin/box plots of each metric per git branch into an AWS-hosted HTML
dashboard; here the same plots render locally with matplotlib (Agg) into
``<root>/dashboard/`` plus a self-contained index.html.
"""
from __future__ import annotations

import html
import pathlib

import numpy as np

from .measure import measurements
from .store import default_root, load_records

__all__ = ["metric_distributions", "render_dashboard",
           "render_detection_panel"]

# fixed 2-color categorical assignment (Tol bright pair, CVD-safe):
# completeness is always blue, false rate always yellow
_DET_COLORS = {"completeness": "#4477AA", "false rate": "#CCBB44"}


def render_detection_panel(detection, out_dir):
    """One figure summarizing ``api.detection_quality`` output: per-set
    completeness / false-positive rates (shared [0, 1] axis, labeled
    bars) beside the per-blend completeness distribution."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sets = sorted(detection)
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(8.4, 3.2))

    x = np.arange(len(sets))
    for i, (name, key) in enumerate((("completeness", "completeness"),
                                     ("false rate", "false_rate"))):
        vals = [detection[s][key] for s in sets]
        bars = ax0.bar(x + (i - 0.5) * 0.38, vals, width=0.34,
                       color=_DET_COLORS[name], label=name)
        for b, v in zip(bars, vals):
            ax0.text(b.get_x() + b.get_width() / 2, v + 0.02, f"{v:.2f}",
                     ha="center", fontsize=7, color="0.25")
    ax0.set_ylim(0, 1.1)
    ax0.set_xticks(x)
    ax0.set_xticklabels([f"set {s}" for s in sets], fontsize=8)
    ax0.set_title("detection vs truth catalog", fontsize=9)
    ax0.legend(fontsize=8, frameon=False)
    ax0.grid(True, axis="y", alpha=0.3)

    data = [[m["completeness"] for m in detection[s]["blends"]]
            for s in sets]
    if all(len(v) > 1 for v in data):
        parts = ax1.violinplot(data, showmedians=True, widths=0.8)
        for pc in parts["bodies"]:
            pc.set_alpha(0.5)
    else:
        for i, v in enumerate(data):
            ax1.plot(np.full(len(v), i + 1), v, "o", alpha=0.7)
    ax1.set_xticks(np.arange(1, len(sets) + 1))
    ax1.set_xticklabels([f"set {s}" for s in sets], fontsize=8)
    ax1.set_ylim(-0.05, 1.05)
    ax1.set_title("per-blend completeness", fontsize=9)
    ax1.grid(True, alpha=0.3)

    fig.tight_layout()
    path = out_dir / "detection.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def metric_distributions(set_id, branches=None, root=None):
    """{metric: {branch: values}} across the latest run of each branch.

    Per-source metrics (the per-band magnitude errors) flatten over sources.
    """
    root = pathlib.Path(root) if root else default_root()
    if branches is None:
        branches = sorted(
            p.name for p in root.iterdir()
            if p.is_dir() and (p / f"set{set_id}.json").exists()
        ) if root.exists() else []

    out = {}
    for branch in branches:
        runs = load_records(set_id, branch=branch, root=root)
        if not runs:
            continue
        records = runs[-1]["records"]
        for name in measurements:
            vals = []
            for rec in records:
                if name in rec and np.isfinite(rec[name]):
                    vals.append(float(rec[name]))
                for src in rec.get("sources", []):
                    if name in src and np.isfinite(src[name]):
                        vals.append(float(src[name]))
            if vals:
                out.setdefault(name, {})[branch] = np.asarray(vals)
    return out


def render_dashboard(set_ids=(1, 2, 3, 4), branches=None, root=None,
                     out_dir=None, detection=None):
    """Render violin/box distribution plots for every metric of every set
    and write an index.html; returns the list of written figure paths.
    ``detection`` (the dict from ``api.detection_quality``) adds a
    detection-quality panel."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    root = pathlib.Path(root) if root else default_root()
    out_dir = pathlib.Path(out_dir) if out_dir else root / "dashboard"
    out_dir.mkdir(parents=True, exist_ok=True)

    written = []
    sections = []
    for set_id in set_ids:
        dists = metric_distributions(set_id, branches=branches, root=root)
        if not dists:
            continue
        names = [n for n in measurements if n in dists]
        ncol = 3
        nrow = (len(names) + ncol - 1) // ncol
        fig, axes = plt.subplots(nrow, ncol,
                                 figsize=(4.2 * ncol, 3.2 * nrow),
                                 squeeze=False)
        for ax in axes.flat[len(names):]:
            ax.axis("off")
        for ax, name in zip(axes.flat, names):
            per_branch = dists[name]
            labels = list(per_branch)
            data = [per_branch[b] for b in labels]
            if all(len(v) > 1 for v in data):
                parts = ax.violinplot(data, showmedians=True, widths=0.8)
                for pc in parts["bodies"]:
                    pc.set_alpha(0.5)
            else:
                for i, v in enumerate(data):
                    ax.plot(np.full(len(v), i + 1), v, "o", alpha=0.7)
            ax.set_xticks(np.arange(1, len(labels) + 1))
            ax.set_xticklabels(labels, rotation=20, fontsize=8)
            ax.set_title(f"{name}\n{measurements[name]}", fontsize=9)
            ax.grid(True, alpha=0.3)
        fig.suptitle(f"blend set {set_id}", fontsize=12)
        fig.tight_layout()
        path = out_dir / f"set{set_id}.png"
        fig.savefig(path, dpi=110)
        plt.close(fig)
        written.append(path)
        sections.append(
            f"<h2>Blend set {html.escape(str(set_id))}</h2>"
            f'<img src="set{set_id}.png" style="max-width:100%">'
        )

    if detection:
        written.append(render_detection_panel(detection, out_dir))
        sections.append(
            "<h2>Detection quality</h2>"
            '<img src="detection.png" style="max-width:100%">'
        )

    index = out_dir / "index.html"
    index.write_text(
        "<html><head><title>scarlet_tpu_torch regression dashboard"
        "</title></head><body><h1>scarlet_tpu_torch regression dashboard</h1>"
        + "".join(sections) + "</body></html>"
    )
    written.append(index)
    return written
