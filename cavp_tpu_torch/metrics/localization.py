"""Sound-localization evaluation (cIoU / AUC / AP / F1 with size buckets),
``cavp_tpu/metrics/localization.py``.

The reference's ``engine/utils.py:50-530`` (``Evaluator`` /
``EvaluatorFull``): host-side accumulators over per-sample scalars, in
numpy, as in the JAX package. Only the merge across processes differs: the
reference's ``dist.all_gather_object``, through ``torch.distributed`` when
a process group of more than one process is up.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _auc_trapezoid(x: Sequence[float], y: Sequence[float]) -> float:
    """sklearn.metrics.auc equivalent (trapezoidal rule)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return float(np.trapezoid(y, x))


class Evaluator:
    """engine/utils.py:50-140 — simple cIoU accumulator with area buckets."""

    def __init__(self):
        self.ciou: List[float] = []
        self.area: List[int] = []
        self.ciou_small: List[float] = []
        self.ciou_med: List[float] = []
        self.ciou_large: List[float] = []
        self.ciou_huge: List[float] = []
        self.score: List[float] = []

    def cal_CIOU(self, bboxes, score, infer, gtmap, thres: float = 0.01):
        infer_map = (np.asarray(infer) >= thres).astype(np.float64)
        gtmap = np.asarray(gtmap)
        ciou = np.sum(infer_map * gtmap) / (
            np.sum(gtmap) + np.sum(infer_map * (gtmap == 0)))
        self.cal_CIoU_area(bboxes, ciou)
        self.ciou.append(float(ciou))
        self.score.append(float(score))
        return ciou

    def cal_area(self, bboxes) -> int:
        areas = [abs((ymax - ymin) * (xmax - xmin))
                 for xmin, ymin, xmax, ymax in bboxes]
        return int(np.mean(areas))

    def cal_CIoU_area(self, bboxes, ciou: float):
        area = self.cal_area(bboxes)
        self.area.append(area)
        if area < 32 ** 2:
            self.ciou_small.append(ciou)
        elif area < 96 ** 2:
            self.ciou_med.append(ciou)
        elif area < 144 ** 2:
            self.ciou_large.append(ciou)
        else:
            self.ciou_huge.append(ciou)

    def finalize_AUC(self, ciou=None) -> float:
        ciou = self.ciou if ciou is None else ciou
        cious = [np.sum(np.array(ciou) >= 0.05 * i) / len(ciou)
                 for i in range(21)]
        thr = [0.05 * i for i in range(21)]
        return _auc_trapezoid(thr, cious)

    def finalize_AP50(self, ciou=None) -> float:
        ciou = self.ciou if ciou is None else ciou
        return float(np.mean(np.array(ciou) >= 0.5))

    def finalize_cIoU(self, ciou=None) -> float:
        ciou = self.ciou if ciou is None else ciou
        return float(np.mean(np.array(ciou)))

    def clear(self):
        self.__init__()


class EvaluatorFull:
    """engine/utils.py:144-530 — full PR/AP/AUC suite with size subsets."""

    MIN_SIZES = {"small": 0, "medium": 32 ** 2, "large": 96 ** 2,
                 "huge": 144 ** 2}
    MAX_SIZES = {"small": 32 ** 2, "medium": 96 ** 2, "large": 144 ** 2,
                 "huge": 10000 ** 2}

    def __init__(self, iou_thrs=(0.5, 0.75), default_conf_thr: float = 0.5):
        self.iou_thrs = iou_thrs
        self.default_conf_thr = default_conf_thr
        self.ciou_list: List[float] = []
        self.area_list: List[int] = []
        self.confidence_list: List[float] = []
        self.name_list: List[str] = []
        self.bb_list: List[int] = []

    def update(self, name: str, area: int, n_boxes: int, ciou: float,
               confidence: float):
        self.name_list.append(name)
        self.area_list.append(area)
        self.bb_list.append(n_boxes)
        self.ciou_list.append(ciou)
        self.confidence_list.append(confidence)

    @staticmethod
    def calc_precision_recall(bb_list, ciou_list, confidence_list,
                              confidence_thr, ciou_thr=0.5
                              ) -> Tuple[float, float]:
        true_pos = false_pos = false_neg = 0
        for bb, ciou, conf in zip(bb_list, ciou_list, confidence_list):
            if bb == 0:
                if conf >= confidence_thr:
                    false_pos += 1
            else:
                if conf >= confidence_thr:
                    if ciou >= ciou_thr:
                        true_pos += 1
                    else:
                        false_pos += 1
                else:
                    false_neg += 1
        precision = 1.0 if true_pos + false_pos == 0 else \
            true_pos / (true_pos + false_pos)
        recall = 1.0 if true_pos + false_neg == 0 else \
            true_pos / (true_pos + false_neg)
        return precision, recall

    def calc_ap(self, bb_list, ciou_list, conf_list, iou_thr=0.5) -> float:
        precision, recall = [], []
        skip = max(1, len(ciou_list) // 200)
        for thr in np.sort(np.array(conf_list))[:-1][::-skip]:
            p, r = self.calc_precision_recall(bb_list, ciou_list, conf_list,
                                              thr, iou_thr)
            precision.append(p)
            recall.append(r)
        # fewer than 2 PR points: the reference's sum over an empty
        # range yields 0.0 (engine/utils.py:224-248), not NaN
        if len(precision) < 2:
            return 0.0
        precision_max = [np.max(precision[i:]) for i in range(len(precision))]
        return float(sum(precision_max[i] * (recall[i + 1] - recall[i])
                         for i in range(len(precision_max) - 1)))

    def cal_auc(self, bb_list, ciou_list) -> float:
        ciou = [c for b, c in zip(bb_list, ciou_list) if b > 0]
        if not ciou:
            return float("nan")
        cious = [np.sum(np.array(ciou) >= 0.05 * i) / len(ciou)
                 for i in range(21)]
        return _auc_trapezoid([0.05 * i for i in range(21)], cious)

    def filter_subset(self, subset, bb_list, area_list, ciou_list, conf_list):
        if subset == "visible":
            ss = [i for i, bb in enumerate(bb_list) if bb > 0]
        elif subset == "non-visible/non-audible":
            ss = [i for i, bb in enumerate(bb_list) if bb == 0]
        elif subset == "all":
            ss = list(range(len(bb_list)))
        else:
            ss = [i for i, sz in enumerate(area_list)
                  if self.MIN_SIZES[subset] <= sz < self.MAX_SIZES[subset]
                  and bb_list[i] > 0]
        return ([bb_list[i] for i in ss], [ciou_list[i] for i in ss],
                [conf_list[i] for i in ss])

    def gather_results(self):
        """The four lists of every process (the reference's
        ``dist.all_gather_object`` x4), in process order."""
        import torch.distributed as dist

        lists = (self.bb_list, self.area_list, self.ciou_list, self.confidence_list)
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return lists
        merged = []
        for lst in lists:
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, list(lst))
            merged.append([v for part in parts for v in part])
        return tuple(merged)

    def finalize_stats(self) -> Dict[str, float]:
        bb_full, area_full, ciou_full, conf_full = self.gather_results()
        out: Dict[str, float] = {}
        for iou_thr in self.iou_thrs:
            for subset in ["all", "visible", "small", "medium", "large",
                           "huge"]:
                bb, ciou, conf = self.filter_subset(
                    subset, bb_full, area_full, ciou_full, conf_full)
                tag = f"{subset}@{int(iou_thr * 100)}"
                if not ciou:
                    out[f"Precision-{tag}"] = float("nan")
                    out[f"F1-{tag}"] = float("nan")
                    out[f"AP-{tag}"] = float("nan")
                    out[f"AUC-{tag}"] = float("nan")
                    continue
                p, _ = self.calc_precision_recall(bb, ciou, conf, -1000,
                                                  iou_thr)
                out[f"Precision-{tag}"] = p * 100
                # F1 sweep over ~10 confidence thresholds
                # (engine/utils.py:320-335; display_results derives its
                # headline f1_max from these)
                conf_thr = sorted(conf)[::max(1, len(conf) // 10)]
                pr = [self.calc_precision_recall(bb, ciou, conf, thr,
                                                 iou_thr)
                      for thr in conf_thr]
                out[f"F1-{tag}"] = [
                    (2 * r_ * p_ / (r_ + p_) if r_ + p_ > 0 else 0.0) * 100
                    for p_, r_ in pr]
                out[f"AP-{tag}"] = self.calc_ap(bb, ciou, conf, iou_thr) * 100
                out[f"AUC-{tag}"] = self.cal_auc(bb, ciou) * 100
        return out

    def precision_at_50(self) -> float:
        ciou = [c for b, c in zip(self.bb_list, self.ciou_list) if b > 0]
        return float(np.mean(np.array(ciou) > 0.5)) if ciou else float("nan")
