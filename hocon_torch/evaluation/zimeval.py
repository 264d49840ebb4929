"""Zimmermann-style pose evaluation.

Port of ``hocon/evaluation/zimeval.py`` (numpy, float64): ``EvalUtil``
accumulates per-joint Euclidean errors of root-aligned keypoints and
reports mean / median error, the PCK curve over thresholds and its AUC;
``VertexErrorMeter`` averages per-vertex errors (object or hand mesh, mm).
"""

from __future__ import annotations

import numpy as np


class EvalUtil:
    """Accumulates keypoint errors; measures per-joint PCK / AUC."""

    def __init__(self, num_kp: int = 21):
        self.num_kp = num_kp
        self._errors: list[list[np.ndarray]] = [[] for _ in range(num_kp)]

    def feed(
        self,
        gt: np.ndarray,
        pred: np.ndarray,
        visibility: np.ndarray | None = None,
    ) -> None:
        """Add one sample. gt/pred: (num_kp, 3) or batched (B, num_kp, 3)."""
        gt = np.asarray(gt, np.float64)
        pred = np.asarray(pred, np.float64)
        if gt.ndim == 3:
            for i in range(gt.shape[0]):
                self.feed(gt[i], pred[i],
                          None if visibility is None else visibility[i])
            return
        err = np.linalg.norm(gt - pred, axis=-1)  # (num_kp,)
        for k in range(self.num_kp):
            if visibility is None or visibility[k]:
                self._errors[k].append(err[k])

    def _per_kp(self):
        return [np.asarray(e) for e in self._errors]

    def get_measures(
        self, val_min: float = 0.0, val_max: float = 50.0, steps: int = 20
    ):
        """Returns (epe_mean_all, epe_median_all, auc_all, pck_curve_all,
        thresholds), the reference's tuple."""
        errs = self._per_kp()
        epe_mean = [float(np.mean(e)) if len(e) else np.nan for e in errs]
        epe_median = [float(np.median(e)) if len(e) else np.nan for e in errs]
        thresholds = np.linspace(val_min, val_max, steps)
        pck_curves = []
        aucs = []
        norm = np.trapezoid(np.ones_like(thresholds), thresholds)
        for e in errs:
            if not len(e):
                pck_curves.append(np.full_like(thresholds, np.nan))
                aucs.append(np.nan)
                continue
            pck = np.asarray([np.mean(e <= t) for t in thresholds])
            pck_curves.append(pck)
            aucs.append(float(np.trapezoid(pck, thresholds) / norm))
        epe_mean_all = float(np.nanmean(epe_mean))
        epe_median_all = float(np.nanmean(epe_median))
        auc_all = float(np.nanmean(aucs))
        pck_curve_all = np.nanmean(np.stack(pck_curves), axis=0)
        return epe_mean_all, epe_median_all, auc_all, pck_curve_all, thresholds


class VertexErrorMeter:
    """Mean per-vertex Euclidean error accumulator (object / hand mesh, mm)."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def feed(self, gt: np.ndarray, pred: np.ndarray,
             mask: np.ndarray | None = None) -> None:
        gt = np.asarray(gt, np.float64)
        pred = np.asarray(pred, np.float64)
        err = np.linalg.norm(gt - pred, axis=-1)  # (..., V)
        if mask is not None:
            err = err * mask
            self._sum += float(err.sum())
            self._count += int(np.asarray(mask).sum())
        else:
            self._sum += float(err.sum())
            self._count += err.size

    @property
    def mean(self) -> float:
        return self._sum / max(self._count, 1)
