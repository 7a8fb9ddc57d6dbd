"""Display helpers: loss curves, image grids — the port's copy of
``vsnca_tpu/utils/display.py`` (parity: ExtraChannels/utils/misc/
display_utils.py:9-75). The plots need matplotlib; ``plotting_available``
says whether it is installed, so that a caller writes the images without
the plots where it is not.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Dict, Optional, Sequence

import numpy as np


def plotting_available() -> bool:
    """Whether matplotlib, which ``plot_losses`` and
    ``flow_viz.plot_vec_field`` need, is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] → uint8."""
    return np.uint8(np.clip(np.asarray(img), 0.0, 1.0) * 255)


def save_image_grid(images: np.ndarray, path: Optional[str] = None) -> np.ndarray:
    """[B, H, W, 3] in [0,1] → horizontally stacked uint8 image
    (display_utils.py:68-75)."""
    grid = np.concatenate([to_uint8(im) for im in images], axis=1)
    if path:
        from PIL import Image

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        Image.fromarray(grid).save(path)
    return grid


def plot_losses(loss_log: Sequence[float], path: Optional[str] = None,
                log10: bool = True):
    """Loss curve PNG (display_utils.py:9-27). Returns the figure array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
    values = np.asarray(loss_log, dtype=np.float64)
    if log10:
        values = np.log10(np.maximum(values, 1e-12))
        ax.set_ylabel("log10(loss)")
    else:
        ax.set_ylabel("loss")
    ax.plot(values)
    ax.set_xlabel("iteration")
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, bbox_inches="tight")
    import io

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    buf.seek(0)
    from PIL import Image

    return np.asarray(Image.open(buf).convert("RGB"))


def save_train_artifacts(
    out_dir: str,
    iteration: int,
    generated: Optional[np.ndarray] = None,
    reference: Optional[np.ndarray] = None,
    loss_log: Optional[Sequence[float]] = None,
    flow_images: Optional[Dict[str, np.ndarray]] = None,
):
    """Per-checkpoint artifact dump: step images, loss plot, flow images —
    the reference's visual-artifact 'test strategy' (SURVEY.md §4)."""
    os.makedirs(out_dir, exist_ok=True)
    if generated is not None:
        save_image_grid(generated, os.path.join(out_dir, f"step_{iteration}.png"))
    if reference is not None:
        save_image_grid(reference, os.path.join(out_dir, f"ref_{iteration}.png"))
    if loss_log:
        plot_losses(loss_log, os.path.join(out_dir, "loss_plot.png"))
    if flow_images:
        from PIL import Image

        for k, v in flow_images.items():
            Image.fromarray(np.asarray(v)).save(
                os.path.join(out_dir, f"{k}_{iteration}.png")
            )
