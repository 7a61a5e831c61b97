"""Point-cloud visualization helpers (port of `egonn_tpu/utils/visualize.py`) —
headless matplotlib equivalents of the
reference's Open3D viewers (misc/point_clouds.py:8-28 draw_pc /
draw_registration_result).  Open3D's interactive window is unavailable in a
headless environment, so these render to a PNG (or any savefig target)
instead; the color scheme matches the reference (source amber, target blue).
"""
from __future__ import annotations

import numpy as np

_SOURCE_COLOR = (1.0, 0.706, 0.0)
_TARGET_COLOR = (0.0, 0.651, 0.929)


def _axes3d():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    return fig, ax


def _scatter(ax, pc: np.ndarray, color, label=None, max_points: int = 20000):
    pc = np.asarray(pc)
    if len(pc) > max_points:
        sel = np.random.default_rng(0).choice(len(pc), max_points, replace=False)
        pc = pc[sel]
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=0.5, c=[color], label=label)


def draw_pc(pc: np.ndarray, out_path: str = "pc.png") -> str:
    """Render one (N, 3) cloud (reference misc/point_clouds.py:21-28)."""
    fig, ax = _axes3d()
    _scatter(ax, pc, _SOURCE_COLOR)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return out_path


def draw_registration_result(source: np.ndarray, target: np.ndarray,
                             transformation: np.ndarray,
                             out_path: str = "registration.png",
                             keypoints: np.ndarray | None = None) -> str:
    """Render source (transformed by the 4x4 pose) over target (reference
    misc/point_clouds.py:8-18); optionally overlay keypoints."""
    t = np.asarray(transformation)
    src = np.asarray(source) @ t[:3, :3].T + t[:3, 3]
    fig, ax = _axes3d()
    _scatter(ax, src, _SOURCE_COLOR, label="source (transformed)")
    _scatter(ax, target, _TARGET_COLOR, label="target")
    if keypoints is not None:
        kp = np.asarray(keypoints)
        ax.scatter(kp[:, 0], kp[:, 1], kp[:, 2], s=12, c="red", marker="x",
                   label="keypoints")
    ax.legend(loc="upper right")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return out_path
