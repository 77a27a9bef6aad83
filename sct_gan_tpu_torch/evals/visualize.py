"""Training-history dashboard (parity: SCT-GAN/notebook_utils.py:1876-2023);
counterpart of ``sct_gan_tpu/evals/visualize.py``. matplotlib is imported
inside the function, with the Agg backend: the module imports without it.

Six-panel matplotlib figure over the trainer's `training_history` dict plus
the automatic overfitting / LR diagnostics the reference prints."""
from __future__ import annotations

from typing import Dict, List, Optional


def visualize_training_progress(training_history: Dict[str, List[float]],
                                save_path: Optional[str] = None):
    """Render the 6-panel dashboard; returns the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    panels = [
        ("Generation loss", [("train_loss", "train"), ("val_loss", "val")]),
        ("Contract vulnerability loss", [("contract_vuln_loss", "train")]),
        ("Line vulnerability loss", [("line_vuln_loss", "train")]),
        ("Learning rate", [("learning_rate", "lr")]),
        ("Discriminator loss", [("discriminator_loss", "disc")]),
        ("Line metrics", [("line_vuln_accuracy", "acc"),
                          ("line_vuln_precision", "prec"),
                          ("line_vuln_recall", "rec")]),
    ]
    for ax, (title, series) in zip(axes.flat, panels):
        for key, label in series:
            ys = training_history.get(key, [])
            if ys:
                ax.plot(range(1, len(ys) + 1), ys, label=label)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.legend(loc="best", fontsize=8)
        ax.grid(alpha=0.3)
    fig.tight_layout()

    # diagnostics (notebook_utils.py:1960-2023)
    train = training_history.get("train_loss", [])
    val = training_history.get("val_loss", [])
    if len(train) >= 3 and len(val) >= 3:
        gap = val[-1] - train[-1]
        if gap > 0.5 * abs(train[-1]):
            print(f"⚠️  Possible overfitting: val-train gap {gap:.4f}")
        if val[-1] > min(val) * 1.5:
            print("⚠️  Validation loss has regressed >50% from its best")
    lrs = training_history.get("learning_rate", [])
    if lrs and lrs[-1] < 1e-7:
        print("⚠️  Learning rate is extremely low — training likely stalled")

    if save_path:
        fig.savefig(save_path, dpi=100)
        print(f"Dashboard saved to {save_path}")
    return fig
