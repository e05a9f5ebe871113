"""KITTI AP11 / AP-R40 evaluation engine.

Re-derivation of ref:lib/eval/eval.py (the kitti-object-eval-python vendor):
same matching rules, ignore semantics, threshold schedule and AP formulas.
The numba.cuda rotated-IoU becomes the vectorized numpy `rotate_iou`; the
per-image greedy matching (`compute_statistics_jit`, ref::157-275) is plain
Python here, with the native C++ engine (`eval/native.py`, built from the
repository's `native/m3deval.cpp`) used where it builds. The port's own
copy of the reference package's engine.

Metric codes: 0 = 2D bbox, 1 = BEV, 2 = 3D. Difficulty: 0 easy / 1 moderate /
2 hard.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence

import numpy as np

from .kitti_common import get_label_annos
from .rotate_iou import d3_box_overlap, rotate_iou

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000


def get_thresholds(scores: np.ndarray, num_gt, num_sample_pts=41):
    """Score thresholds at ~evenly spaced recall points (ref::7-25)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) \
                and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    """Per-image ignore flags (ref::28-82).

    ignored flag: 0 = evaluate, 1 = ignore (neutral), -1 = remove.
    """
    current_cls_name = CLASS_NAMES[current_class]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D box overlap, vectorized (ref::84-113; no +1 convention)."""
    if boxes.shape[0] == 0 or query_boxes.shape[0] == 0:
        return np.zeros([boxes.shape[0], query_boxes.shape[0]])
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw > 0) & (ih > 0), inter, 0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy per-image matching (ref::157-275 compute_statistics_jit).

    overlaps: [num_dt, num_gt] IoU matrix for this image.
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] \
                    or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if not compute_fp and overlap > min_overlap \
                    and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif compute_fp and overlap > min_overlap \
                    and (overlap > max_overlap or assigned_ignored_det) \
                    and ignored_det[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif compute_fp and overlap > min_overlap \
                    and valid_detection == NO_DETECTION \
                    and ignored_det[j] == 1:
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION \
                and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] in (-1, 1)
                    or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes,
                                               np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if assigned_detection[j] or ignored_det[j] in (-1, 1) \
                            or ignored_threshold[j]:
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def compute_statistics_fast(overlaps, gt_datas, dt_datas, ignored_gt,
                            ignored_det, dc_bboxes, metric, min_overlap,
                            thresh=0.0, compute_fp=False, compute_aos=False,
                            dt_dc_overlaps=None):
    """`compute_statistics` with the inner detection scan vectorized.

    Same greedy semantics (equivalence-tested against the transcription
    above): per ground truth, the running-max scan over detections becomes
    one masked numpy argmax — the earliest index wins ties exactly like the
    sequential strict-> comparison. Used by the pure-Python fallback so a
    host without a C++ toolchain stays usable (ref:lib/eval/eval.py:290-336
    `fused_compute_statistics` batches the same way with numba upstream).

    dt_dc_overlaps: optional precomputed [num_dt, num_dc] DontCare overlap
    matrix (it does not depend on the threshold — callers batching the 41
    thresholds compute it once per image).
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    ignored_det = np.asarray(ignored_det)

    if compute_fp:
        ignored_threshold = dt_scores < thresh
    else:
        ignored_threshold = np.zeros(det_size, bool)
    assigned = np.zeros(det_size, bool)
    base_cand = (ignored_det != -1) & ~ignored_threshold
    is_det0 = ignored_det == 0
    is_det1 = ignored_det == 1

    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        cand = base_cand & ~assigned
        ov = overlaps[:, i]
        det_idx = -1
        valid_detection = NO_DETECTION
        if not compute_fp:
            m = cand & (ov > min_overlap)
            if m.any():
                det_idx = int(np.argmax(np.where(m, dt_scores, -np.inf)))
                valid_detection = dt_scores[det_idx]
        else:
            # priority: max-overlap among evaluated (ignored_det == 0)
            # detections; else the first ignorable (== 1) one
            m0 = cand & (ov > min_overlap) & is_det0
            if m0.any():
                det_idx = int(np.argmax(np.where(m0, ov, -np.inf)))
                valid_detection = 1
            else:
                m1 = cand & (ov > min_overlap) & is_det1
                if m1.any():
                    det_idx = int(np.argmax(m1))       # first True
                    valid_detection = 1
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION \
                and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        eligible = ~assigned & is_det0 & ~ignored_threshold
        fp = int(np.count_nonzero(eligible))
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            if dt_dc_overlaps is None:
                dt_dc_overlaps = image_box_overlap(
                    dt_datas[:, :4], np.asarray(dc_bboxes), 0)
            nstuff = int(np.count_nonzero(
                eligible & (dt_dc_overlaps.max(axis=1) > min_overlap)))
        fp -= nstuff
        if compute_aos:
            tmp = (1.0 + np.cos(np.asarray(delta))) / 2.0
            similarity = float(tmp.sum()) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def fused_statistics_py(overlaps, gt_datas, dt_datas, ignored_gt,
                        ignored_det, dc_bboxes, metric, min_overlap,
                        thresholds, compute_aos, pr):
    """Accumulate tp/fp/fn/similarity into pr [nthresh, 4] for one image —
    the pure-Python twin of native.fused_statistics (and of the reference's
    numba `fused_compute_statistics`, ref:lib/eval/eval.py:290-336).

    ALL thresholds are matched simultaneously: the per-gt greedy step runs
    once on [T, num_dt] matrices (the threshold only enters through which
    detections are below it), so the python fallback costs one matrix
    matching per image instead of 41 separate matchings. Equivalence with
    the per-threshold transcription loop is tested."""
    T = len(thresholds)
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    if T == 0:
        return
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    ignored_det = np.asarray(ignored_det)
    thr = np.asarray(thresholds, np.float64)

    ignored_threshold = dt_scores[None, :] < thr[:, None]       # [T, D]
    base_cand = (ignored_det != -1)[None, :] & ~ignored_threshold
    is_det0 = (ignored_det == 0)[None, :]
    is_det1 = (ignored_det == 1)[None, :]
    assigned = np.zeros((T, det_size), bool)

    tp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    sim = np.zeros(T, np.float64)
    rows = np.arange(T)
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        ov = overlaps[:, i][None, :]                            # [1, D]
        cand = base_cand & ~assigned
        m0 = cand & (ov > min_overlap) & is_det0
        any0 = m0.any(axis=1)
        idx0 = np.argmax(np.where(m0, ov, -np.inf), axis=1)
        m1 = cand & (ov > min_overlap) & is_det1
        any1 = ~any0 & m1.any(axis=1)
        det_idx = np.where(any0, idx0, np.argmax(m1, axis=1))   # [T]
        has = any0 | any1
        if ignored_gt[i] == 0:
            fn += ~has
        assigned[rows[has], det_idx[has]] = True
        if ignored_gt[i] != 1:
            tp_mask = has & (ignored_det[det_idx] != 1)
            tp += tp_mask
            if compute_aos:
                d = gt_alphas[i] - dt_alphas[det_idx]
                sim += np.where(tp_mask, (1.0 + np.cos(d)) / 2.0, 0.0)

    eligible = ~assigned & is_det0 & ~ignored_threshold
    fp = eligible.sum(axis=1)
    if metric == 0 and len(dc_bboxes) > 0:
        dt_dc = image_box_overlap(dt_datas[:, :4], np.asarray(dc_bboxes), 0)
        stuffed = (dt_dc.max(axis=1) > min_overlap)[None, :]
        fp -= (eligible & stuffed).sum(axis=1)
    pr[:, 0] += tp
    pr[:, 1] += fp
    pr[:, 2] += fn
    # per-threshold sim is -1 (not accumulated) only when tp == fp == 0, and
    # then the delta sum is 0 anyway — unconditional add is identical
    pr[:, 3] += sim


_ENGINE_LOGGED = False


def _log_engine(use_native: bool):
    """Say loudly (once per process) which matching engine runs — the
    silent fallback to pure Python is minutes-to-hours on a full val split."""
    global _ENGINE_LOGGED
    if _ENGINE_LOGGED:
        return
    _ENGINE_LOGGED = True
    if use_native:
        logging.info("KITTI eval engine: native C++ (eval/native.py)")
    else:
        logging.warning(
            "KITTI eval engine: pure Python fallback — the native C++ "
            "engine is unavailable (no g++ toolchain, failed build, or "
            "M3DSSD_NO_NATIVE=1). Evaluation of large splits will be "
            "markedly slower.")


def _image_overlaps(gt_annos, dt_annos, metric):
    """Per-image [num_dt, num_gt] overlap matrices (ref::340-436
    calculate_iou_partly, without the partitioning — numpy batches per image
    are already vectorized). Uses the native C++ kernels when built."""
    from . import native
    use_native = native.available()
    riou = native.rotated_iou if use_native else rotate_iou
    d3 = native.d3_box_overlap if use_native else d3_box_overlap
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(dt["bbox"], gt["bbox"])
        elif metric == 1:
            gb = np.concatenate([gt["location"][:, [0, 2]],
                                 gt["dimensions"][:, [0, 2]],
                                 gt["rotation_y"][:, None]], axis=1)
            db = np.concatenate([dt["location"][:, [0, 2]],
                                 dt["dimensions"][:, [0, 2]],
                                 dt["rotation_y"][:, None]], axis=1)
            o = riou(db, gb)
        elif metric == 2:
            gb = np.concatenate([gt["location"], gt["dimensions"],
                                 gt["rotation_y"][:, None]], axis=1)
            db = np.concatenate([dt["location"], dt["dimensions"],
                                 dt["rotation_y"][:, None]], axis=1)
            o = d3(db, gb)
        else:
            raise ValueError("unknown metric")
        overlaps.append(o.astype(np.float64))
    return overlaps


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc = clean_data(
            gt, dt, current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, dtype=np.int64))
        ignored_dets.append(np.array(ignored_det, dtype=np.int64))
        dontcares.append(np.stack(dc, 0).astype(np.float64) if dc
                         else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt["bbox"], gt["alpha"][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """AP curves per (class, difficulty, min_overlap) (ref::448-552)."""
    assert len(gt_annos) == len(dt_annos)
    from . import native
    use_native = native.available()
    _log_engine(use_native)
    stats_fn = native.compute_statistics if use_native \
        else compute_statistics_fast
    overlaps = _image_overlaps(gt_annos, dt_annos, metric)

    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    num_minoverlap = len(min_overlaps)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap,
                          N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = stats_fn(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap, compute_fp=False)
                    thresholdss += th.tolist()
                if total_num_valid_gt == 0:
                    continue
                thresholds = np.array(get_thresholds(
                    np.array(thresholdss), total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                if use_native:
                    for i in range(len(gt_annos)):
                        native.fused_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap, thresholds, compute_aos, pr)
                else:
                    for i in range(len(gt_annos)):
                        fused_statistics_py(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap, thresholds, compute_aos, pr)
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                # monotone envelope (ref::543-549)
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:])
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:])
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:])
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    """AP11: precision at recall 0, 0.1, ..., 1.0 (ref::555-559)."""
    return sum(prec[..., i] for i in range(0, prec.shape[-1], 4)) / 11 * 100


def get_mAP_R40(prec):
    """AP-R40: 40 points skipping recall 0 (ref::562-566)."""
    return sum(prec[..., i] for i in range(1, prec.shape[-1])) / 40 * 100


CLASS_TO_NAME = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                 4: "Person_sitting", 5: "Truck"}
NAME_TO_CLASS = {v: k for k, v in CLASS_TO_NAME.items()}

OVERLAP_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3)


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    """Full protocol: bbox/BEV/3D/AOS x AP11/R40 (ref::638-746).

    Returns (result string, ret_dict of named scalars).
    """
    min_overlaps = OVERLAP_0_7[None]     # [1, 3(metric), 6(class)]
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    classes = [NAME_TO_CLASS[c] if isinstance(c, str) else int(c)
               for c in current_classes]
    min_overlaps = min_overlaps[:, :, classes]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            compute_aos = anno["alpha"][0] != -10
            break

    difficultys = [0, 1, 2]
    results = {}
    for metric, name in [(0, "image"), (1, "bev"), (2, "3d")]:
        ret = eval_class(gt_annos, dt_annos, classes, difficultys, metric,
                         min_overlaps, compute_aos and metric == 0)
        results[name] = get_mAP(ret["precision"])
        results[name + "_R40"] = get_mAP_R40(ret["precision"])
        if metric == 0 and compute_aos:
            results["aos"] = get_mAP(ret["orientation"])
            results["aos_R40"] = get_mAP_R40(ret["orientation"])

    lines = []
    ret_dict = {}
    for j, c in enumerate(classes):
        cname = CLASS_TO_NAME[c]
        lines.append(f"{cname} AP@{min_overlaps[0, 0, j]:.2f}, "
                     f"{min_overlaps[0, 1, j]:.2f}, {min_overlaps[0, 2, j]:.2f}:")
        for name, label in [("image", "bbox"), ("bev", "bev "), ("3d", "3d  ")]:
            v = results[name][j, :, 0]
            lines.append(f"{label} AP:{v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f}")
            v40 = results[name + "_R40"][j, :, 0]
            lines.append(f"{label} AP_R40:{v40[0]:.4f}, {v40[1]:.4f}, {v40[2]:.4f}")
            for d, dn in enumerate(["easy", "moderate", "hard"]):
                ret_dict[f"{cname}_{name}_{dn}"] = float(v[d])
                ret_dict[f"{cname}_{name}_{dn}_R40"] = float(v40[d])
        if "aos" in results:
            v = results["aos"][j, :, 0]
            v40 = results["aos_R40"][j, :, 0]
            lines.append(f"aos  AP:{v[0]:.2f}, {v[1]:.2f}, {v[2]:.2f}")
            for d, dn in enumerate(["easy", "moderate", "hard"]):
                ret_dict[f"{cname}_aos_{dn}"] = float(v[d])
                ret_dict[f"{cname}_aos_{dn}_R40"] = float(v40[d])
    return "\n".join(lines), ret_dict


def evaluate_kitti(gt_path: str, results_path: str,
                   classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist")
                   ) -> Dict[str, List[float]]:
    """Directory-level entry point: returns grouped metric lists, e.g.
    {'Car_3d_R40': [easy, mod, hard], ...}."""
    dt_annos = get_label_annos(results_path)
    gt_annos = get_label_annos(gt_path)
    text, ret = get_official_eval_result(gt_annos, dt_annos, list(classes))
    logging.info("\n%s", text)
    grouped: Dict[str, List[float]] = {}
    for cname in classes:
        for metric in ["image", "bev", "3d", "aos"]:
            for suffix in ["", "_R40"]:
                keys = [f"{cname}_{metric}_{d}{suffix}"
                        for d in ["easy", "moderate", "hard"]]
                if all(k in ret for k in keys):
                    grouped[f"{cname}_{metric}{suffix}"] = [ret[k] for k in keys]
    grouped["_text"] = text
    return grouped
