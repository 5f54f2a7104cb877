"""Image, detection and overlay plots, and multi-run training curves, with
matplotlib (port of cosypose_tpu/visualization/plotter.py).

matplotlib is imported inside the methods, as in the JAX package: importing
this module needs none, and the card's machine has none.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np


def _hwc(img: np.ndarray) -> np.ndarray:
    return np.transpose(img, (1, 2, 0)) if img.ndim == 3 and img.shape[0] in (1, 3) else img


class Plotter:
    def __init__(self):
        import matplotlib

        matplotlib.use("Agg")

    def plot_image(self, image, ax=None):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        img = _hwc(np.asarray(image))
        if img.dtype != np.uint8 and img.max() <= 1.0:
            img = (img * 255).astype(np.uint8)
        ax.imshow(img)
        ax.axis("off")
        return ax

    def plot_detections(self, ax, detections, color="lime"):
        """Boxes of a TensorCollection with tensor 'bboxes' and columns
        'label' (and 'score')."""
        import matplotlib.patches as patches

        boxes = np.asarray(detections.bboxes.detach().cpu())
        score = detections.infos.get("score")
        for n in range(len(detections)):
            x1, y1, x2, y2 = boxes[n]
            ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False, color=color,
                                           lw=1.5))
            label = detections.infos["label"][n]
            txt = label if score is None else f"{label} {score[n]:.2f}"
            ax.text(x1, y1 - 2, txt, color=color, fontsize=7)
        return ax

    def plot_overlay(self, rgb_input, rgb_rendered, alpha=0.6, ax=None):
        """The rendered image blended over the input where it drew."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        inp = _hwc(np.asarray(rgb_input, np.float32))
        ren = _hwc(np.asarray(rgb_rendered, np.float32))
        if inp.max() > 1:
            inp = inp / 255.0
        if ren.max() > 1:
            ren = ren / 255.0
        mask = (ren.sum(-1) > 0)[..., None]
        ax.imshow(np.clip(np.where(mask, alpha * ren + (1 - alpha) * inp, inp), 0, 1))
        ax.axis("off")
        return ax

    def save(self, fig_or_ax, path):
        import matplotlib.pyplot as plt

        fig = getattr(fig_or_ax, "figure", fig_or_ax)
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)


def plot_training_logs(run_dirs, metrics=("train/loss_total",), out_path=None):
    """Multi-run training curves from each run's log.txt (jsonlines)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(metrics), figsize=(5 * len(metrics), 4), squeeze=False)
    for run_dir in map(pathlib.Path, run_dirs):
        log = run_dir / "log.txt"
        if not log.exists():
            continue
        records = [json.loads(line) for line in log.read_text().splitlines() if line.strip()]
        for m, ax in zip(metrics, axes[0]):
            ax.plot([r["epoch"] for r in records if m in r], [r[m] for r in records if m in r],
                    label=run_dir.name)
            ax.set_xlabel("epoch")
            ax.set_title(m)
    for ax in axes[0]:
        ax.legend(fontsize=7)
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig
