"""Scan2CAD-style mAP over oriented boxes.

Reimplements the reference evaluation protocol
(upstream utils/calc_map.py:40-243): VOC AP (11-point and
continuous), greedy per-class PR matching, multiprocessing fan-out over
classes, and the NMS used by the detectors.

One deliberate fix vs the reference: `eval_det_multiprocessing` there zips
pool results against ``gt.keys()`` while the pool input was filtered to
classes present in ``pred`` (calc_map.py:215-219), silently misaligning
results when a GT class has no predictions. We keep the API and the "AP=0
for classes without predictions" behavior but align results by class name.

Provenance: ``voc_ap`` / ``eval_det_cls`` / ``nms`` intentionally follow the
reference's control flow closely (calc_map.py:40-243), which is itself the
standard public VOC / votenet evaluation code (facebookresearch/votenet
``eval_det.py``). Exact protocol reproduction is required for mAP-parity
claims, so this is a transliteration by design, not an original algorithm.
"""

from __future__ import annotations

from multiprocessing import Pool

import numpy as np

from canonicalvoting_tpu_torch.metrics.iou import get_iou_obb


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC AP from PR points (reference calc_map.py:40-71)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            if np.sum(rec >= t) == 0:
                p = 0
            else:
                p = np.max(prec[rec >= t])
            ap = ap + p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False,
                 get_iou_func=get_iou_obb):
    """Single-class PR + AP with greedy GT matching
    (reference calc_map.py:78-168).

    pred: {img_id: [(bbox, score)]}; gt: {img_id: [bbox]}.
    """
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        bbox = np.array(gt[img_id])
        det = [False] * len(bbox)
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": det}
    for img_id in pred.keys():
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids = []
    confidence = []
    BB = []
    for img_id in pred.keys():
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    confidence = np.array(confidence)
    BB = np.array(BB)

    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, ...] if len(BB) else BB
    image_ids = [image_ids[x] for x in sorted_ind]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d, ...].astype(float)
        ovmax = -np.inf
        jmax = -1
        BBGT = R["bbox"].astype(float)
        if BBGT.size > 0:
            for j in range(BBGT.shape[0]):
                iou = get_iou_func(bb, BBGT[j, ...])
                if iou > ovmax:
                    ovmax = iou
                    jmax = j
        if ovmax > ovthresh:
            if not R["det"][jmax]:
                tp[d] = 1.0
                R["det"][jmax] = 1
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap


def _eval_det_cls_wrapper(arguments):
    pred, gt, ovthresh, use_07_metric, get_iou_func = arguments
    return eval_det_cls(pred, gt, ovthresh, use_07_metric, get_iou_func)


def eval_det_multiprocessing(pred_all, gt_all, ovthresh=0.25,
                             use_07_metric=False, get_iou_func=get_iou_obb,
                             processes=10):
    """Multi-class PR/AP with a process pool over classes
    (reference calc_map.py:177-226).

    pred_all: {img_id: [(classname, bbox, score)]};
    gt_all:   {img_id: [(classname, bbox)]}.
    Returns ({cls: rec}, {cls: prec}, {cls: ap}) with classes taken from GT;
    classes with no predictions get rec=prec=ap=0.
    """
    pred = {}
    gt = {}
    for img_id in pred_all.keys():
        for classname, bbox, score in pred_all[img_id]:
            pred.setdefault(classname, {}).setdefault(img_id, []).append(
                (bbox, score)
            )
            gt.setdefault(classname, {}).setdefault(img_id, [])
    for img_id in gt_all.keys():
        for classname, bbox in gt_all[img_id]:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(bbox)

    classnames = [c for c in gt.keys() if c in pred]
    jobs = [
        (pred[c], gt[c], ovthresh, use_07_metric, get_iou_func)
        for c in classnames
    ]
    if processes and processes > 1 and len(jobs) > 1:
        with Pool(processes=min(processes, max(len(jobs), 1))) as p:
            ret_values = p.map(_eval_det_cls_wrapper, jobs)
    else:
        ret_values = [_eval_det_cls_wrapper(j) for j in jobs]

    rec, prec, ap = {}, {}, {}
    by_name = dict(zip(classnames, ret_values))
    for classname in gt.keys():
        if classname in by_name:
            rec[classname], prec[classname], ap[classname] = by_name[classname]
        else:
            rec[classname] = 0
            prec[classname] = 0
            ap[classname] = 0
    return rec, prec, ap


def nms(boxes, scores, overlap_threshold, get_iou_func=get_iou_obb):
    """Greedy NMS keeping highest scores first
    (reference calc_map.py:229-243 / eval_joint.py:75-89)."""
    scores = np.asarray(scores)
    if scores.size == 0:
        return []
    I = np.argsort(scores)
    pick = []
    while I.size != 0:
        last = I.size
        i = I[-1]
        pick.append(int(i))
        suppress = [last - 1]
        for pos in range(last - 1):
            j = I[pos]
            o = get_iou_func(boxes[i], boxes[j])
            if o > overlap_threshold:
                suppress.append(pos)
        I = np.delete(I, suppress)
    return pick


def compute_map(pred_map_cls, gt_map_cls, ovthresh=0.5, processes=10):
    """Aggregate dict with per-class AP/Recall + mAP/AR
    (reference train_joint.py:158-175)."""
    rec, prec, ap = eval_det_multiprocessing(
        pred_map_cls, gt_map_cls, ovthresh=ovthresh, processes=processes
    )
    ret_dict = {}
    for key in sorted(ap.keys()):
        ret_dict["%s Average Precision" % str(key)] = ap[key]
    ret_dict["mAP"] = np.mean(list(ap.values())) if ap else 0.0
    rec_list = []
    for key in sorted(ap.keys()):
        try:
            ret_dict["%s Recall" % str(key)] = rec[key][-1]
            rec_list.append(rec[key][-1])
        except (TypeError, IndexError):
            ret_dict["%s Recall" % str(key)] = 0
            rec_list.append(0)
    ret_dict["AR"] = np.mean(rec_list) if rec_list else 0.0
    return ret_dict
