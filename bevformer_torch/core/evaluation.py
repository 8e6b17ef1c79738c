"""Self-contained nuScenes detection metrics (NDS / mAP / TP errors).

The port's own copy of `bevformer_tpu/core/evaluation.py` (the port imports
nothing of the JAX package): a numpy implementation of the nuScenes devkit
detection evaluation used by the reference (`datasets/nuscnes_eval.py:
507-570` wraps the devkit; the devkit itself is pure python). It runs on
the host, as the devkit does. `bevformer_torch.tools.test` also writes the
standard submission JSON for the official devkit.

Algorithm (devkit `detection/algo.py` semantics):
  * per (class, dist_threshold in {0.5, 1, 2, 4} m): sort all predictions by
    score desc, greedy-match each to the nearest unmatched GT of that class
    in the same sample by BEV center distance;
  * AP = area of the 101-point interpolated precision-recall curve above
    precision 0.1 and recall 0.1, normalized by 0.9^2;
  * TP errors (ATE trans, ASE scale, AOE orient, AVE vel, AAE attr) are
    cumulative means over TPs at dist 2.0 m, averaged over the recall range
    [0.1, max_recall];
  * NDS = (5 * mAP + sum(1 - min(1, err))) / 10.

Boxes are 9-dim (x, y, z_gravity, w, l, h, yaw, vx, vy) in the per-sample
lidar frame; center distances are frame-invariant so evaluating in lidar
coordinates is equivalent to the devkit's global-frame evaluation.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from bevformer_torch.core.boxes import CLASS_NAMES
from bevformer_torch.core.geometry import quat_to_rot

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# devkit: barriers have no velocity/attribute; cones neither
NO_VEL_CLASSES = {"barrier", "traffic_cone"}
NO_ATTR_CLASSES = {"barrier", "traffic_cone"}
# devkit caps orientation error at pi/2 ("period" of pi) for barriers
BARRIER_YAW_PERIOD = {"barrier": np.pi}

ERR_NAME_MAPPING = {
    "trans_err": "mATE",
    "scale_err": "mASE",
    "orient_err": "mAOE",
    "vel_err": "mAVE",
    "attr_err": "mAAE",
}

# Per-class default attributes (mmdet3d NuScenesDataset.DefaultAttribute,
# mirrored at `projects/mmdet3d_plugin/datasets/nuscenes_mono_dataset.py:
# 51-62`); consumed by the reference's inherited
# `_format_bbox` when writing submissions (`nuscenes_dataset.py:184-240`).
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}

_MOVING_VEHICLES = {"car", "construction_vehicle", "bus", "truck", "trailer"}


def predict_attribute(class_name: str, velocity_xy) -> str:
    """The velocity-derived default-attribute rule applied to every
    predicted box by mmdet3d's `NuScenesDataset._format_bbox` (inherited by
    the reference's CustomNuScenesDataset; mAAE — 10% of the non-mAP half
    of NDS — depends on it)."""
    v = float(np.hypot(velocity_xy[0], velocity_xy[1]))
    if v > 0.2:
        if class_name in _MOVING_VEHICLES:
            return "vehicle.moving"
        if class_name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE.get(class_name, "")
    if class_name == "pedestrian":
        return "pedestrian.standing"
    if class_name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(class_name, "")


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit `cummean`: cumulative mean ignoring NaN entries (a NaN marks
    a TP whose GT has no attribute); all-NaN -> ones."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    s = np.nancumsum(x.astype(np.float64))
    c = np.cumsum(~np.isnan(x))
    return np.divide(s, c, out=np.zeros_like(s), where=c != 0)


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def _scale_iou(gt: np.ndarray, pred: np.ndarray) -> float:
    """Size-aligned 3D IoU (devkit scale_iou): boxes centered + axis aligned."""
    minima = np.minimum(gt[3:6], pred[3:6])
    inter = float(np.prod(minima))
    union = float(np.prod(gt[3:6]) + np.prod(pred[3:6]) - inter)
    return inter / max(union, 1e-12)


def accumulate_class(
    gts: Dict[str, np.ndarray],
    preds: List[Dict],
    dist_th: float,
    with_tp: bool,
    yaw_period: float,
    use_vel: bool,
    gt_attrs: Optional[Dict[str, np.ndarray]] = None,
):
    """gts: sample_token -> [G, 9]; preds: list of dicts with sample_token,
    box [9], score, optional 'attr' (string). gt_attrs: token -> [G] GT
    attribute names aligned with gts (devkit: '' = no attribute -> NaN,
    excluded from the attr cummean). Returns (precision, recall, conf at
    101 recall points, tp error curves)."""
    npos = sum(len(v) for v in gts.values())
    if npos == 0:
        return None

    preds = sorted(preds, key=lambda d: -d["score"])
    taken = defaultdict(set)
    tp, fp = [], []
    match_err = {k: [] for k in TP_METRICS}
    for p in preds:
        g = gts.get(p["token"])
        best, best_d = None, float("inf")
        if g is not None and len(g):
            d = np.linalg.norm(g[:, :2] - p["box"][:2][None], axis=1)
            for j in np.argsort(d):
                if j in taken[p["token"]]:
                    continue
                best, best_d = j, d[j]
                break
        if best is not None and best_d < dist_th:
            taken[p["token"]].add(best)
            tp.append(1.0)
            fp.append(0.0)
            if with_tp:
                gb = g[best]
                pb = p["box"]
                match_err["trans_err"].append(float(best_d))
                match_err["scale_err"].append(1.0 - _scale_iou(gb, pb))
                match_err["orient_err"].append(
                    _yaw_diff(gb[6], pb[6], period=yaw_period)
                )
                match_err["vel_err"].append(
                    float(np.linalg.norm(gb[7:9] - pb[7:9])) if use_vel else 0.0
                )
                if gt_attrs is not None and p["token"] in gt_attrs:
                    ga = str(gt_attrs[p["token"]][best])
                    match_err["attr_err"].append(
                        np.nan
                        if ga == ""
                        else 1.0 - float(ga == p.get("attr", ""))
                    )
                else:
                    match_err["attr_err"].append(
                        1.0 - p.get("attr_correct", 0.0)
                    )
        else:
            tp.append(0.0)
            fp.append(1.0)

    if not tp:
        return dict(
            precision=np.zeros(101),
            recall=np.linspace(0, 1, 101),
            tp_errors={k: None for k in TP_METRICS},
            max_recall=0.0,
        )

    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    prec = tp / np.maximum(tp + fp, 1e-12)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, 101)
    prec_101 = np.interp(rec_interp, rec, prec, right=0)

    out_err = {}
    if with_tp:
        for k in TP_METRICS:
            vals = np.array(match_err[k], np.float64)
            if len(vals) == 0:
                out_err[k] = None
            else:
                cum = _cummean(vals)
                # devkit interpolates the cummean over the recall axis of TPs
                tp_rec = np.cumsum(np.ones(len(vals))) / npos
                out_err[k] = np.interp(
                    rec_interp, tp_rec, cum, right=cum[-1] if len(cum) else 1.0
                )
    return dict(
        precision=prec_101,
        recall=rec_interp,
        tp_errors=out_err if with_tp else {k: None for k in TP_METRICS},
        max_recall=float(rec[-1]),
    )


def calc_ap(precision_101: np.ndarray, min_recall=0.1, min_precision=0.1):
    prec = precision_101.copy()
    prec = prec[int(min_recall * 100) + 1 :]  # devkit: round(100*min_recall)+1
    prec -= min_precision
    prec[prec < 0] = 0
    return float(prec.sum()) / len(prec) / (1.0 - min_precision)


def calc_tp(md, min_recall=0.1) -> float:
    if md is None:
        return 1.0
    first = int(min_recall * 100) + 1
    last = int(round(md["max_recall"] * 100))  # devkit uses max_recall_ind
    if last < first:
        return 1.0
    curve = md["_tp_curve"]
    return float(np.mean(curve[first : last + 1]))


def evaluate_detections(
    results: Sequence[Dict],
    gt_by_token: Dict[str, Dict[str, np.ndarray]],
    class_names: Sequence[str] = CLASS_NAMES,
    verbose: bool = False,
) -> Dict:
    """results: per-sample dicts {token, boxes_3d [N,9] (bottom z),
    scores_3d, labels_3d}; gt_by_token: token -> {boxes [G,9] bottom z,
    labels [G]}. Returns the devkit-style metrics dict (NDS, mAP, per-class
    APs, TP errors)."""
    # convert to gravity-center z for distance/scale parity with devkit
    def to_gravity(b):
        b = np.array(b, np.float64)
        if len(b):
            b[:, 2] += 0.5 * b[:, 5]
        return b

    preds_by_class: Dict[int, List[Dict]] = defaultdict(list)
    for r in results:
        boxes = to_gravity(r["boxes_3d"])
        for i, (b, s, l) in enumerate(
            zip(boxes, r["scores_3d"], r["labels_3d"])
        ):
            # predicted attribute: given explicitly, else the reference's
            # velocity-derived rule (mmdet3d _format_bbox)
            if "attrs" in r:
                attr = str(r["attrs"][i])
            else:
                attr = predict_attribute(class_names[int(l)], b[7:9])
            preds_by_class[int(l)].append(
                dict(token=r["token"], box=b, score=float(s), attr=attr)
            )

    gts_by_class: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
    attrs_by_class: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
    any_gt_attrs = False
    for token, g in gt_by_token.items():
        boxes = to_gravity(g["boxes"])
        labels = np.asarray(g["labels"])
        attrs = g.get("attrs")
        if attrs is not None:
            any_gt_attrs = True
            attrs = np.asarray(attrs, dtype=object)
        for ci in range(len(class_names)):
            sel = labels == ci
            if sel.any():
                gts_by_class[ci][token] = boxes[sel]
                if attrs is not None:
                    attrs_by_class[ci][token] = attrs[sel]

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tp: Dict[str, Dict[str, float]] = {}
    for ci, cname in enumerate(class_names):
        gts = gts_by_class.get(ci, {})
        preds = preds_by_class.get(ci, [])
        label_aps[cname] = {}
        label_tp[cname] = {}
        yaw_period = BARRIER_YAW_PERIOD.get(cname, 2 * np.pi)
        use_vel = cname not in NO_VEL_CLASSES
        for th in DIST_THRESHOLDS:
            md = accumulate_class(
                gts, preds, th, with_tp=(th == 2.0), yaw_period=yaw_period,
                use_vel=use_vel,
                gt_attrs=attrs_by_class.get(ci) if any_gt_attrs else None,
            )
            if md is None:
                label_aps[cname][th] = float("nan")
                continue
            label_aps[cname][th] = calc_ap(md["precision"])
            if th == 2.0:
                for k in TP_METRICS:
                    if (k == "vel_err" and not use_vel) or (
                        k == "attr_err" and cname in NO_ATTR_CLASSES
                    ):
                        label_tp[cname][k] = float("nan")
                        continue
                    curve = md["tp_errors"].get(k)
                    if curve is None:
                        label_tp[cname][k] = 1.0
                    else:
                        label_tp[cname][k] = calc_tp(
                            {"max_recall": md["max_recall"], "_tp_curve": curve}
                        )

    aps = [
        v
        for c in label_aps.values()
        for v in c.values()
        if not np.isnan(v)
    ]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    tp_errors = {}
    for k in TP_METRICS:
        vals = [
            label_tp[c][k]
            for c in label_tp
            if k in label_tp[c] and not np.isnan(label_tp[c][k])
        ]
        tp_errors[k] = float(np.mean(vals)) if vals else 1.0

    nds = (
        5.0 * mean_ap + sum(1.0 - min(1.0, tp_errors[k]) for k in TP_METRICS)
    ) / 10.0

    metrics = dict(
        mean_ap=mean_ap,
        nd_score=float(nds),
        label_aps=label_aps,
        label_tp_errors=label_tp,
        tp_errors=tp_errors,
    )
    if verbose:
        print(f"mAP: {mean_ap:.4f}  NDS: {nds:.4f}")
        for k, v in tp_errors.items():
            print(f"  {ERR_NAME_MAPPING[k]}: {v:.4f}")
    return metrics


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of two (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def format_submission(
    results: Sequence[Dict],
    info_by_token: Dict[str, Dict],
    meta: Optional[Dict] = None,
) -> Dict:
    """Standard nuScenes detection submission JSON (the reference's
    inherited `NuScenesDataset._format_bbox`, consumed at
    `projects/mmdet3d_plugin/datasets/nuscenes_dataset.py:184-240`): boxes
    lifted lidar -> ego -> global, yaw converted back from the SECOND
    convention, velocity rotated to global, and each box given
    the class/velocity-derived `attribute_name` (`predict_attribute`).

    results: per-sample {token, boxes_3d [N,9] bottom-z lidar frame,
    scores_3d, labels_3d}; info_by_token: token -> info dict carrying
    lidar2ego_* / ego2global_* (the converter schema).
    """
    out: Dict[str, List[Dict]] = {}
    for r in results:
        token = r["token"]
        info = info_by_token[token]
        q_l2e = np.asarray(info["lidar2ego_rotation"], np.float64)
        t_l2e = np.asarray(info["lidar2ego_translation"], np.float64)
        q_e2g = np.asarray(info["ego2global_rotation"], np.float64)
        t_e2g = np.asarray(info["ego2global_translation"], np.float64)
        r_l2e, r_e2g = quat_to_rot(q_l2e), quat_to_rot(q_e2g)

        boxes = np.asarray(r["boxes_3d"], np.float64).reshape(-1, 9)
        annos = []
        for b, s, l in zip(boxes, r["scores_3d"], r["labels_3d"]):
            name = CLASS_NAMES[int(l)]
            center = b[:3].copy()
            center[2] += 0.5 * b[5]  # bottom -> gravity z
            center = r_e2g @ (r_l2e @ center + t_l2e) + t_e2g
            # internal yaw is SECOND convention: yaw_nusc = -yaw - pi/2
            yaw = -float(b[6]) - np.pi / 2
            q_box = np.array(
                [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
            )
            q_global = _quat_mul(q_e2g, _quat_mul(q_l2e, q_box))
            vel = r_e2g[:2, :2] @ (r_l2e[:2, :2] @ b[7:9])
            annos.append(
                dict(
                    sample_token=token,
                    translation=center.tolist(),
                    size=b[3:6].tolist(),  # (w, l, h) — devkit order
                    rotation=q_global.tolist(),
                    velocity=vel.tolist(),
                    detection_name=name,
                    detection_score=float(s),
                    attribute_name=predict_attribute(name, b[7:9]),
                )
            )
        out[token] = annos
    return dict(
        meta=meta
        or dict(
            use_camera=True,
            use_lidar=False,
            use_radar=False,
            use_map=False,
            use_external=False,
        ),
        results=out,
    )


def filter_boxes_by_overlap(
    boxes: np.ndarray,
    lidar2img: np.ndarray,
    img_shape,
    min_depth: float = 1.0,
) -> np.ndarray:
    """Camera-overlap visibility mask for the reference's `overlap_test`
    evaluation mode (`datasets/nuscnes_eval.py:436-505` +
    `:575-579`): keep only boxes whose (gravity) center projects inside
    MORE THAN ONE camera image. The devkit's `center_in_image` requires
    depth > 1 m and the pixel strictly inside the image.

    boxes: [N, >=3] with gravity-center xyz in the lidar frame;
    lidar2img: [cams, 4, 4]; img_shape: (h, w) UNPADDED camera size.
    Returns a boolean keep-mask [N].
    """
    boxes = np.asarray(boxes, np.float64)
    if len(boxes) == 0:
        return np.zeros((0,), bool)
    centers = np.concatenate(
        [boxes[:, :3], np.ones((len(boxes), 1))], axis=1
    )  # [N, 4]
    proj = np.einsum("cij,nj->cni", np.asarray(lidar2img, np.float64), centers)
    z = proj[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        xy = proj[..., :2] / np.maximum(z[..., None], 1e-9)
    h, w = img_shape
    vis = (
        (z > min_depth)
        & (xy[..., 0] > 0)
        & (xy[..., 0] < w)
        & (xy[..., 1] > 0)
        & (xy[..., 1] < h)
    )  # [cams, N]
    return vis.sum(axis=0) > 1


def apply_overlap_filter(results, gt_by_token, lidar2img_by_token, img_shape):
    """Filter predictions AND ground truth to camera-overlap regions
    (in-place semantics of `NuScenesEval_custom(overlap_test=True)`).
    Box z is bottom-center here (the results/gt convention); centers are
    lifted to gravity z for projection."""

    def lift(b):
        b = np.array(b, np.float64)
        if len(b):
            b = b.copy()
            b[:, 2] += 0.5 * b[:, 5]
        return b

    out_results = []
    for r in results:
        l2i = lidar2img_by_token[r["token"]]
        keep = filter_boxes_by_overlap(lift(r["boxes_3d"]), l2i, img_shape)
        out_results.append(
            dict(
                r,
                boxes_3d=np.asarray(r["boxes_3d"])[keep],
                scores_3d=np.asarray(r["scores_3d"])[keep],
                labels_3d=np.asarray(r["labels_3d"])[keep],
            )
        )
    out_gt = {}
    for token, g in gt_by_token.items():
        keep = filter_boxes_by_overlap(
            lift(g["boxes"]), lidar2img_by_token[token], img_shape
        )
        out_gt[token] = dict(
            g, boxes=np.asarray(g["boxes"])[keep],
            labels=np.asarray(g["labels"])[keep],
        )
        # the attributes go with their boxes (the JAX package's filter
        # leaves them whole, and its evaluation then fails on the mismatch)
        if g.get("attrs") is not None:
            out_gt[token]["attrs"] = np.asarray(g["attrs"], dtype=object)[keep]
    return out_results, out_gt
