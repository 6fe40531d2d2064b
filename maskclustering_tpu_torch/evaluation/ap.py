"""ScanNet-benchmark average-precision evaluation.

Protocol parity with reference evaluation/evaluate.py: AP averaged over IoU
thresholds 0.5:0.05:0.95 plus AP50/AP25 (evaluate.py:44, 207-224), minimum
region size 100 vertices (evaluate.py:46), greedy confidence-ordered gt<->pred
matching with void/group/small-instance ignore rules (evaluate.py:53-205), and
the same convolution-based precision-recall integration (evaluate.py:192-198).

Port of ``maskclustering_tpu/evaluation/ap.py:30-373``. The reference
computes one GPU matmul per prediction mask against the same-label GT
tensor (evaluate.py:313-314); here, as in the JAX package, ALL pred x gt
intersections of a scan are one counting product of (N_pts, P)^T @
(N_pts, G) on the run's device, plus a matvec for void intersections
(``ops.counting.count_dot``: float32 products of {0, 1} operands, exact
below 2^24 vertices under either ``count_dtype``); only the small (P, G)
count matrix comes back to the host for the greedy pass, which stays numpy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.evaluation.instances import GTInstance, group_instances, load_gt_ids
from maskclustering_tpu_torch.ops import counting
from maskclustering_tpu_torch.semantics.vocab import get_vocab

# IoU thresholds: 0.50..0.90 step 0.05, then 0.25 (reference evaluate.py:44).
DEFAULT_OVERLAPS: np.ndarray = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
# Minimum instance size in vertices (reference evaluate.py:46).
MIN_REGION_SIZE: int = 100


def _intersection_counts(pred_masks: torch.Tensor, gt_onehot: torch.Tensor,
                         void_mask: torch.Tensor, count_dtype: str = "bf16"):
    """(P, G) intersection counts + (P,) void intersections, two counting
    products on the tensors' device.

    Kept in the encoding's accumulator (``out_dtype=None``): int32 for
    ``"int8"``, float32 for ``"bf16"``, which rounds to int32 exactly below
    2^24 (``ap.py:48-50``) — identical int32 counts either way.
    """
    def to_i32(x):
        return (x.to(torch.int32) if not torch.is_floating_point(x)
                else torch.round(x).to(torch.int32))

    inter = to_i32(counting.count_dot(
        pred_masks.T, gt_onehot, count_dtype=count_dtype, out_dtype=None))
    void = to_i32(counting.count_dot(
        pred_masks.T, void_mask, count_dtype=count_dtype, out_dtype=None))
    return inter, void


class _Pred:
    """One retained prediction and its GT overlap records."""

    __slots__ = ("uid", "label_id", "vert_count", "confidence",
                 "void_intersection", "matched_gt")

    def __init__(self, uid, label_id, vert_count, confidence, void_intersection):
        self.uid = uid
        self.label_id = label_id
        self.vert_count = vert_count
        self.confidence = confidence
        self.void_intersection = void_intersection
        self.matched_gt: List[Tuple[GTInstance, int]] = []  # (gt, intersection)


class _GTRecord:
    """One GT instance and the predictions that touch it."""

    __slots__ = ("inst", "matched_pred")

    def __init__(self, inst: GTInstance):
        self.inst = inst
        self.matched_pred: List[Tuple[_Pred, int]] = []  # (pred, intersection)


def assign_instances_for_scan(
    pred_masks: np.ndarray,  # (N_pts, P) -- nonzero = member
    pred_scores: np.ndarray,  # (P,)
    pred_classes: np.ndarray,  # (P,)
    gt_ids: np.ndarray,  # (N_pts,)
    labels: Sequence[str],
    valid_ids: Sequence[int],
    *,
    no_class: bool = False,
    scan_key: str = "scan",
    min_region_size: int = MIN_REGION_SIZE,
    count_dtype: str = "bf16",
    device: DeviceLike = None,
) -> Tuple[Dict[str, List[_GTRecord]], Dict[str, List[_Pred]]]:
    """Match one scan's predictions to GT (reference evaluate.py:254-329).

    Returns (gt2pred, pred2gt), both keyed by class label. The intersection
    counts run on ``device`` (CUDA unless the caller names another).
    """
    dev = resolve_device(device)
    id_to_label = {int(v): l for v, l in zip(valid_ids, labels)}
    if no_class:
        # collapse every annotated vertex onto the first valid class
        # (reference evaluate.py:261-262, 282-283)
        gt_ids = gt_ids % 1000 + int(valid_ids[0]) * 1000

    gt_instances = group_instances(gt_ids, valid_ids, labels, id_to_label)
    gt2pred: Dict[str, List[_GTRecord]] = {
        label: [_GTRecord(inst) for inst in insts]
        for label, insts in gt_instances.items()
    }
    pred2gt: Dict[str, List[_Pred]] = {label: [] for label in labels}

    # flatten GT instances into one one-hot tensor; columns are grouped by
    # label, so each label owns a contiguous [start, stop) column range
    columns: List[np.ndarray] = []
    label_cols: Dict[str, Tuple[int, int]] = {}
    for label in labels:
        start = len(columns)
        for rec in gt2pred[label]:
            columns.append(gt_ids == rec.inst.instance_id)
        label_cols[label] = (start, len(columns))
    gt_onehot = (np.stack(columns, axis=1) if columns
                 else np.zeros((len(gt_ids), 0), dtype=bool))
    void = ~np.isin(gt_ids // 1000, np.asarray(valid_ids))

    masks_bool = np.not_equal(pred_masks, 0)
    if pred_masks.shape[0] != len(gt_ids):
        raise ValueError(
            f"{scan_key}: prediction has {pred_masks.shape[0]} vertices "
            f"but GT has {len(gt_ids)}")
    inter, void_inter = _intersection_counts(
        torch.from_numpy(masks_bool).to(dev), torch.from_numpy(gt_onehot).to(dev),
        torch.from_numpy(void).to(dev), count_dtype=count_dtype)
    inter = inter.cpu().numpy()
    void_inter = void_inter.cpu().numpy()
    vert_counts = masks_bool.sum(axis=0)

    for i in range(masks_bool.shape[1]):
        label_id = int(valid_ids[0]) if no_class else int(pred_classes[i])
        if label_id not in id_to_label:
            continue
        if vert_counts[i] < min_region_size:
            continue  # too small to evaluate (evaluate.py:300-301)
        label = id_to_label[label_id]
        pred = _Pred(
            uid=f"{scan_key}_{i}",
            label_id=label_id,
            vert_count=int(vert_counts[i]),
            confidence=float(pred_scores[i]),
            void_intersection=int(void_inter[i]),
        )
        # same-label GT overlaps only (evaluate.py:313-323); the label's
        # columns are contiguous, so only its nonzero entries are visited
        start, stop = label_cols[label]
        for j in np.nonzero(inter[i, start:stop])[0]:
            n = int(inter[i, start + j])
            pred.matched_gt.append((gt2pred[label][j].inst, n))
            gt2pred[label][j].matched_pred.append((pred, n))
        pred2gt[label].append(pred)
    return gt2pred, pred2gt


def _average_precision(y_true: np.ndarray, y_score: np.ndarray,
                       hard_false_negatives: int) -> float:
    """AP from matched samples (reference evaluate.py:156-198, vectorized).

    Precision/recall are evaluated at each unique confidence cutoff, then
    integrated with the [-0.5, 0, 0.5] convolution step rule.
    """
    order = np.argsort(y_score)
    ys, yt = y_score[order], y_true[order]
    cum = np.cumsum(yt)
    _, first_idx = np.unique(ys, return_index=True)
    num_examples = len(ys)
    num_true = cum[-1]
    # matches with score strictly below each cutoff (0 at the lowest cutoff)
    below = np.where(first_idx > 0, cum[first_idx - 1], 0.0)
    tp = num_true - below
    fp = num_examples - first_idx - tp
    fn = below + hard_false_negatives
    precision = np.append(tp / (tp + fp), 1.0)  # final point is artificial
    recall = np.append(tp / (tp + fn), 0.0)
    r = np.concatenate([recall[:1], recall, [0.0]])
    step_widths = np.convolve(r, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def evaluate_matches(
    matches: Dict[str, Dict[str, Dict[str, list]]],
    labels: Sequence[str],
    *,
    overlaps: np.ndarray = DEFAULT_OVERLAPS,
    min_region_size: int = MIN_REGION_SIZE,
) -> np.ndarray:
    """Greedy AP per (class, overlap) over all scans (evaluate.py:53-205).

    ``matches[scan] = {"gt": gt2pred, "pred": pred2gt}``. Returns
    (len(labels), len(overlaps)) float array; NaN marks classes with no GT
    and no predictions.
    """
    ap = np.zeros((len(labels), len(overlaps)), dtype=float)
    for oi, overlap_th in enumerate(overlaps):
        visited: Dict[str, bool] = {}
        for scan in matches.values():
            for preds in scan["pred"].values():
                for p in preds:
                    visited[p.uid] = False
        for li, label in enumerate(labels):
            y_true_parts: List[np.ndarray] = []
            y_score_parts: List[np.ndarray] = []
            hard_false_negatives = 0
            has_gt = False
            has_pred = False
            for scan in matches.values():
                pred_instances: List[_Pred] = scan["pred"][label]
                gt_records: List[_GTRecord] = [
                    r for r in scan["gt"][label]
                    if r.inst.instance_id >= 1000
                    and r.inst.vert_count >= min_region_size
                ]
                has_gt = has_gt or bool(gt_records)
                has_pred = has_pred or bool(pred_instances)

                cur_true = [1.0] * len(gt_records)
                cur_score = [-np.inf] * len(gt_records)
                cur_match = [False] * len(gt_records)
                for gi, rec in enumerate(gt_records):
                    found_match = False
                    for pred, inter in rec.matched_pred:
                        if visited[pred.uid]:
                            continue  # greedy: each pred matches one GT
                        union = rec.inst.vert_count + pred.vert_count - inter
                        if inter / union <= overlap_th:
                            continue
                        if cur_match[gi]:
                            # duplicate detection: lower-confidence one
                            # becomes a false positive (evaluate.py:100-109)
                            lo = min(cur_score[gi], pred.confidence)
                            cur_score[gi] = max(cur_score[gi], pred.confidence)
                            cur_true.append(0.0)
                            cur_score.append(lo)
                            cur_match.append(True)
                        else:
                            found_match = True
                            cur_match[gi] = True
                            cur_score[gi] = pred.confidence
                            visited[pred.uid] = True
                    if not found_match:
                        hard_false_negatives += 1
                matched = np.asarray(cur_match, dtype=bool)
                y_true_parts.append(np.asarray(cur_true)[matched])
                y_score_parts.append(np.asarray(cur_score)[matched])

                # unmatched predictions: false positives unless mostly
                # covering ignored regions (evaluate.py:124-146)
                for pred in pred_instances:
                    matched_any = any(
                        inter / (gt.vert_count + pred.vert_count - inter) > overlap_th
                        for gt, inter in pred.matched_gt)
                    if matched_any:
                        continue
                    num_ignore = pred.void_intersection
                    for gt, inter in pred.matched_gt:
                        if gt.instance_id < 1000:  # annotation group
                            num_ignore += inter
                        if gt.vert_count < min_region_size:
                            num_ignore += inter
                    if num_ignore / pred.vert_count <= overlap_th:
                        y_true_parts.append(np.zeros(1))
                        y_score_parts.append(np.full(1, pred.confidence))

            if has_gt and has_pred:
                y_true = np.concatenate(y_true_parts) if y_true_parts else np.empty(0)
                y_score = np.concatenate(y_score_parts) if y_score_parts else np.empty(0)
                ap[li, oi] = (0.0 if len(y_score) == 0 else
                              _average_precision(y_true, y_score, hard_false_negatives))
            elif has_gt:
                ap[li, oi] = 0.0
            else:
                ap[li, oi] = np.nan
    return ap


def compute_averages(aps: np.ndarray, labels: Sequence[str],
                     overlaps: np.ndarray = DEFAULT_OVERLAPS) -> Dict:
    """AP / AP50 / AP25 summaries (reference evaluate.py:207-224)."""
    import warnings

    o50 = np.isclose(overlaps, 0.5)
    o25 = np.isclose(overlaps, 0.25)
    not25 = ~o25
    with warnings.catch_warnings():
        # all-NaN when no class has GT or predictions; NaN result is correct
        warnings.simplefilter("ignore", category=RuntimeWarning)
        out = {
            "all_ap": float(np.nanmean(aps[:, not25])),
            "all_ap_50%": float(np.nanmean(aps[:, o50])),
            "all_ap_25%": float(np.nanmean(aps[:, o25])),
            "classes": {},
        }
    for li, label in enumerate(labels):
        out["classes"][label] = {
            "ap": float(np.average(aps[li, not25])),
            "ap50%": float(np.average(aps[li, o50])),
            "ap25%": float(np.average(aps[li, o25])),
        }
    return out


def format_results(avgs: Dict, labels: Sequence[str]) -> str:
    """Console AP table (reference evaluate.py:331-368)."""
    width = 64
    lines = ["#" * width,
             "{:<15}:{:>15}{:>15}{:>15}".format("what", "AP", "AP_50%", "AP_25%"),
             "#" * width]
    for label in labels:
        c = avgs["classes"][label]
        if np.isnan(c["ap"]):
            continue
        lines.append("{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
            label, c["ap"], c["ap50%"], c["ap25%"]))
    lines.append("-" * width)
    lines.append("{:<15}:{:>15.3f}{:>15.3f}{:>15.3f}".format(
        "average", avgs["all_ap"], avgs["all_ap_50%"], avgs["all_ap_25%"]))
    return "\n".join(lines)


def write_result_file(avgs: Dict, labels: Sequence[str], valid_ids: Sequence[int],
                      path: str) -> None:
    """CSV-ish result file (reference evaluate.py:370-381)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("class,class id,ap,ap50,ap25\n")
        for label, vid in zip(labels, valid_ids):
            c = avgs["classes"][label]
            f.write(f"{label},{vid},{c['ap']},{c['ap50%']},{c['ap25%']}\n")
        f.write(f"{avgs['all_ap']},{avgs['all_ap_50%']},{avgs['all_ap_25%']}\n")


def _load_prediction_npz(path: str):
    pred = np.load(path)
    return pred["pred_masks"], pred["pred_score"], pred["pred_classes"]


def evaluate_scans(
    pred_files: Sequence[str],
    gt_files: Sequence[str],
    dataset: str,
    *,
    no_class: bool = False,
    output_file: Optional[str] = None,
    verbose: bool = True,
    count_dtype: str = "bf16",
    device: DeviceLike = None,
) -> Dict:
    """Evaluate npz predictions against GT txt files (evaluate.py:383-400);
    the intersection counts run on ``device`` (CUDA unless named)."""
    labels, valid_ids = get_vocab(dataset)
    device = resolve_device(device)
    matches = {}
    for pred_file, gt_file in zip(pred_files, gt_files):
        masks, scores, classes = _load_prediction_npz(pred_file)
        gt_ids = load_gt_ids(gt_file)
        gt2pred, pred2gt = assign_instances_for_scan(
            masks, scores, classes, gt_ids, labels, valid_ids,
            no_class=no_class, scan_key=os.path.basename(pred_file),
            count_dtype=count_dtype, device=device)
        matches[os.path.abspath(gt_file)] = {"gt": gt2pred, "pred": pred2gt}
    aps = evaluate_matches(matches, labels)
    avgs = compute_averages(aps, labels)
    if verbose:
        print(format_results(avgs, labels))
    if output_file:
        write_result_file(avgs, labels, valid_ids, output_file)
    return avgs
