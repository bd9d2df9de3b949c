"""Match / keypoint / detection-box visualization.

Port of ``stereo_semantic_vo_tpu.viz.matches``: the same figures, from torch
tensors (on any device) or numpy arrays; matplotlib is imported inside each
function.

Offline replacement for the reference's debug draws: the side-by-side match
image (pnpmatch.cc:201-235 — which stalled tracking 100 ms per frame on
cv::waitKey) and the detection-box overlay (semantic.cc:34-43).  Pure
matplotlib, written to disk, never on the hot path.
"""

from __future__ import annotations

import numpy as np

from stereo_semantic_vo_tpu_torch.viz.plot import to_numpy


def draw_matches(
    img1: np.ndarray,
    img2: np.ndarray,
    uv1: np.ndarray,
    uv2: np.ndarray,
    matched: np.ndarray,
    out_path: str = "matches.png",
    max_draw: int = 200,
) -> str:
    """Side-by-side frames with match lines (uv1[i] <-> uv2[i] where matched)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img1 = to_numpy(img1)
    img2 = to_numpy(img2)
    uv1 = to_numpy(uv1)
    uv2 = to_numpy(uv2)
    H = max(img1.shape[0], img2.shape[0])
    W1 = img1.shape[1]
    canvas = np.zeros((H, W1 + img2.shape[1]), np.float32)
    canvas[: img1.shape[0], :W1] = img1
    canvas[: img2.shape[0], W1:] = img2

    fig, ax = plt.subplots(figsize=(14, 5))
    ax.imshow(canvas, cmap="gray", vmin=0, vmax=255)
    idx = np.nonzero(to_numpy(matched))[0][:max_draw]
    for i in idx:
        x1, y1 = uv1[i]
        x2, y2 = uv2[i]
        ax.plot([x1, x2 + W1], [y1, y2], "-", lw=0.5, alpha=0.7)
    ax.scatter(uv1[idx, 0], uv1[idx, 1], s=4, c="lime")
    ax.scatter(uv2[idx, 0] + W1, uv2[idx, 1], s=4, c="cyan")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def draw_boxes(
    img: np.ndarray,
    boxes: np.ndarray,
    valid: np.ndarray,
    uv: np.ndarray | None = None,
    culled: np.ndarray | None = None,
    out_path: str = "boxes.png",
) -> str:
    """Detection boxes (+ optionally keypoints, culled ones highlighted)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(to_numpy(img), cmap="gray", vmin=0, vmax=255)
    for b, v in zip(to_numpy(boxes), to_numpy(valid)):
        if not v:
            continue
        x1, y1, x2, y2 = b
        ax.add_patch(
            patches.Rectangle((x1, y1), x2 - x1, y2 - y1, lw=1.5, ec="red", fc="none")
        )
    if uv is not None:
        uv = to_numpy(uv)
        ax.scatter(uv[:, 0], uv[:, 1], s=3, c="lime")
        if culled is not None:
            c = to_numpy(culled)
            ax.scatter(uv[c, 0], uv[c, 1], s=10, c="red", marker="x")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
