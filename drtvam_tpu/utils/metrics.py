"""Print-quality metrics + dose histogram artifact.

Replaces reference utils.py: `iou_loss` (:8-11) and `save_histogram`
(:48-81) — the post-optimization report of dose distributions for
object/void voxels, the threshold sweep maximizing IoU, the normalized
threshold, and pattern energy efficiency.
"""
from __future__ import annotations

import numpy as np


def iou(pred, target, threshold=0.9):
    """Intersection-over-union of thresholded dose vs binary target
    (reference utils.py:8-11)."""
    pred = np.asarray(pred).ravel()
    target = np.asarray(target).ravel()
    obj = target > 0.0
    thr = pred > threshold
    union = np.count_nonzero(thr | obj)
    if union == 0:
        return float("nan")
    return np.count_nonzero(thr & obj) / union


# keep the reference's name available too
iou_loss = iou


def save_histogram(vol, target, filename, efficiency, max_pattern_intensity,
                   n_thresholds=300, verbose=True):
    """Best-IoU threshold sweep over [0, 1.3] plus the dose histogram
    PNG (reference utils.py:48-81). The sweep is printed and returned
    always; the PNG is drawn only where matplotlib imports. Returns
    (best_iou, best_threshold)."""
    vol = np.asarray(vol)
    target = np.asarray(target)
    obj_mask = target.ravel() > 0.0
    voxels = vol.ravel()

    if verbose:
        print("Finding threshold for best IoU ...")
    thresholds = np.linspace(0, 1.3, n_thresholds)
    # vectorized sweep (reference loops one iou render per threshold)
    thr = voxels[None, :] > thresholds[:, None]
    inter = np.count_nonzero(thr & obj_mask[None, :], axis=1)
    union = np.count_nonzero(thr | obj_mask[None, :], axis=1)
    ious = inter / np.maximum(union, 1)
    best = int(np.argmax(ious))
    best_iou = float(ious[best])
    best_threshold_normalized = thresholds[best] / max_pattern_intensity
    if verbose:
        print("Best IoU: {:.4f}".format(best_iou))
        print("Best threshold: {:4f}".format(thresholds[best]))

    try:
        import matplotlib
    except ImportError:
        if verbose:
            print(f"matplotlib not installed: {filename} not drawn")
        return best_iou, float(thresholds[best])
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 5))
    plt.hist(voxels[obj_mask], bins=500, label="Object", alpha=0.55)
    plt.hist(voxels[~obj_mask], bins=500, label="Empty", alpha=0.55)
    plt.xlim([0, 1.2])
    plt.title("pattern energy efficiency = {:.4f}, IoU = {:.4f} at "
              "threshold = {:.3f}, normalized threshold = {:.3f}".format(
                  efficiency, best_iou, thresholds[best],
                  best_threshold_normalized))
    plt.yscale("log")
    plt.ylabel("# Voxels")
    plt.xlabel("Received dose")
    plt.legend()
    plt.savefig(filename)
    plt.close()
    return best_iou, float(thresholds[best])
