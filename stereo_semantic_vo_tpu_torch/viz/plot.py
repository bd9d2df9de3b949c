"""Headless trajectory / map visualization.

Port of ``stereo_semantic_vo_tpu.viz.plot``: the same figures, from torch
tensors (on any device) or numpy arrays.  matplotlib is imported inside each
function, so nothing on a card path needs it.

Replaces the reference's Pangolin immediate-mode viewer (src/view.cc:
DrawGraph green trajectory segments, DrawMappoints colored point cloud;
main.cpp:117-136 window setup) with matplotlib figures written to disk —
accelerator hosts are headless, and visualization must never stall the
tracker the way the reference's GL FinishFrame + cv::waitKey do.
"""

from __future__ import annotations

import numpy as np


def to_numpy(x) -> np.ndarray:
    """A torch tensor (detached, moved to the CPU) or array-like -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_trajectory(
    est_positions: np.ndarray,
    gt_positions: np.ndarray | None = None,
    out_path: str = "trajectory.png",
    title: str = "trajectory (x-z plane)",
) -> str:
    """Top-down (x, z) trajectory plot, KITTI convention."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    est = to_numpy(est_positions)
    ax.plot(est[:, 0], est[:, 2], "g-", lw=1.2, label="estimate")
    if gt_positions is not None:
        gt = to_numpy(gt_positions)
        ax.plot(gt[:, 0], gt[:, 2], "k--", lw=1.0, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_map_points(
    points: np.ndarray,
    valid: np.ndarray,
    est_positions: np.ndarray | None = None,
    out_path: str = "map.png",
) -> str:
    """Top-down map-point scatter (DrawMappoints analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    p = to_numpy(points)[to_numpy(valid)]
    ax.scatter(p[:, 0], p[:, 2], s=2, c=np.clip(p[:, 1], -3, 3), cmap="viridis")
    if est_positions is not None:
        est = to_numpy(est_positions)
        ax.plot(est[:, 0], est[:, 2], "r-", lw=1.5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
