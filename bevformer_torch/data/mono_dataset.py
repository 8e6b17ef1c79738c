"""Monocular 3D detection dataset (per-camera COCO-style annotations) and
its submission formatter, numpy on the host.

Port of `bevformer_tpu/data/mono_dataset.py` (reference
`CustomNuScenesMonoDataset`, `datasets/nuscenes_mono_dataset.py:20-630`): a
COCO-format per-image dataset for camera-frame 3D detection (FCOS3D-style
mono training), and the formatter that merges the 6 per-camera result lists
of a frame, deduplicates them with rotated BEV NMS across cameras, and
names nuScenes attributes from predicted attribute indices with the
class-consistency override (`get_attr_name`, reference `:231-274`).

Registered but unused by every shipped BEVFormer config (V2's perspective
head trains through `data/dataset_v2.py`'s DD3D targets instead); provided
for parity. As in the JAX package: annotations come back as padded
fixed-shape arrays with a valid mask; the geometry is explicit quaternion
and matrix math (`core.geometry`), no devkit; the cross-camera NMS runs in
the global (x, y) BEV plane, where the reference uses the first camera's
(x, z) plane (`:313-318`): rotated IoU is invariant under rigid motions of
the plane, so the two differ only through camera pitch and roll.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from bevformer_torch.core.evaluation import CLASS_NAMES
from bevformer_torch.core.geometry import quat_to_rot

# reference `:50-62` (also mmdet3d NuScenesDataset.DefaultAttribute)
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

# reference `:240-245` (AttrMapping_rev2): predicted attr-head index -> name
ATTR_NAMES = (
    "cycle.with_rider",
    "cycle.without_rider",
    "pedestrian.moving",
    "pedestrian.standing",
    "pedestrian.sitting_lying_down",
    "vehicle.moving",
    "vehicle.parked",
    "vehicle.stopped",
    "None",
)

_VEHICLES = ("car", "bus", "truck", "trailer", "construction_vehicle")

# detection_cvpr_2019 class_range (devkit config; consumed at reference
# `:701-705` for the ego-frame distance filter)
CLASS_RANGE = {
    "car": 50.0,
    "truck": 50.0,
    "bus": 50.0,
    "trailer": 50.0,
    "construction_vehicle": 50.0,
    "pedestrian": 40.0,
    "motorcycle": 40.0,
    "bicycle": 40.0,
    "traffic_cone": 30.0,
    "barrier": 30.0,
}


def get_attr_name(attr_idx: int, label_name: str) -> str:
    """Predicted attribute index -> name, with the class-consistency
    override (reference `:231-274`): keep the predicted attribute only if
    it belongs to the predicted class's attribute family, else fall back
    to the class default."""
    attr = ATTR_NAMES[int(attr_idx)] if 0 <= int(attr_idx) < 9 else "None"
    if label_name in _VEHICLES:
        ok = attr in ("vehicle.moving", "vehicle.parked", "vehicle.stopped")
    elif label_name == "pedestrian":
        ok = attr in (
            "pedestrian.moving",
            "pedestrian.standing",
            "pedestrian.sitting_lying_down",
        )
    elif label_name in ("bicycle", "motorcycle"):
        ok = attr in ("cycle.with_rider", "cycle.without_rider")
    else:
        ok = False
    return attr if ok else DEFAULT_ATTRIBUTE.get(label_name, "")


class NuScenesMonoDataset:
    """COCO-format per-camera mono 3D dataset.

    `ann_file` is a COCO-style dict/JSON: `images` carry token +
    cam2ego_/ego2global_ quaternions, `cam_intrinsic`, width/height;
    `annotations` carry `bbox` [x, y, w, h], `category_id`,
    `attribute_id`, `bbox_cam3d` [x, y, z, dx, dy, dz, yaw] (gravity
    center, camera frame), `velo_cam3d` [vx, vz], `center2d`
    [u, v, depth] (the schema mmdet3d's `export_2d_annotation` writes,
    consumed at reference `:134-230`)."""

    CLASSES = CLASS_NAMES

    def __init__(
        self,
        ann_file,
        max_boxes: int = 64,
        load_interval: int = 1,
        with_velocity: bool = True,
    ):
        if isinstance(ann_file, str):
            with open(ann_file) as f:
                coco = json.load(f)
        else:
            coco = ann_file
        self.images: List[Dict] = list(coco["images"])[::load_interval]
        self.max_boxes = max_boxes
        self.with_velocity = with_velocity
        cats = coco.get("categories")
        if cats:
            self.cat2label = {
                c["id"]: self.CLASSES.index(c["name"])
                for c in cats
                if c["name"] in self.CLASSES
            }
        else:  # category_id already a 0..9 label
            self.cat2label = {i: i for i in range(len(self.CLASSES))}
        self._anns_by_img: Dict[int, List[Dict]] = {}
        for a in coco.get("annotations", []):
            self._anns_by_img.setdefault(a["image_id"], []).append(a)

    def __len__(self) -> int:
        return len(self.images)

    def get_ann_info(self, idx: int) -> Dict[str, np.ndarray]:
        """Padded static-shape targets for image `idx`.

        Applies the reference's validity filters (`:152-163`): clipped-away
        2D boxes, degenerate (<1 px) boxes, foreign categories, and crowd
        boxes are dropped; NaN velocities zeroed (`:176-177`)."""
        img = self.images[idx]
        m = self.max_boxes
        out = dict(
            bboxes=np.zeros((m, 4), np.float32),
            labels=np.full((m,), -1, np.int64),
            attr_labels=np.full((m,), len(ATTR_NAMES) - 1, np.int64),
            bboxes_cam3d=np.zeros((m, 9), np.float32),
            centers2d=np.zeros((m, 2), np.float32),
            depths=np.zeros((m,), np.float32),
            valid=np.zeros((m,), bool),
        )
        k = 0
        for ann in self._anns_by_img.get(img["id"], []):
            if k >= m:
                break
            if ann.get("ignore", False) or ann.get("iscrowd", False):
                continue
            x1, y1, w, h = [float(v) for v in ann["bbox"]]
            iw = max(0.0, min(x1 + w, img["width"]) - max(x1, 0.0))
            ih = max(0.0, min(y1 + h, img["height"]) - max(y1, 0.0))
            if iw * ih == 0 or ann.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if ann["category_id"] not in self.cat2label:
                continue
            b3d = np.asarray(ann["bbox_cam3d"], np.float32).reshape(-1)[:7]
            velo = np.nan_to_num(
                np.asarray(
                    ann.get("velo_cam3d", (0.0, 0.0)), np.float32
                ).reshape(2)
            )
            if not self.with_velocity:
                velo = np.zeros(2, np.float32)
            out["bboxes"][k] = (x1, y1, x1 + w, y1 + h)
            out["labels"][k] = self.cat2label[ann["category_id"]]
            out["attr_labels"][k] = int(ann.get("attribute_id", 8))
            out["bboxes_cam3d"][k, :7] = b3d
            out["bboxes_cam3d"][k, 7:] = velo
            c2d = np.asarray(ann["center2d"], np.float32).reshape(-1)
            out["centers2d"][k] = c2d[:2]
            out["depths"][k] = c2d[2]
            out["valid"][k] = True
            k += 1
        return out


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> (w, x, y, z) unit quaternion (Shepperd)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 0.0)) * 2
    q = np.empty(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _box_corners_bev(cx, cy, dx, dy, yaw) -> np.ndarray:
    """[N] params -> [N, 4, 2] rotated-rectangle corners in the BEV plane."""
    c, s = np.cos(yaw), np.sin(yaw)
    ox = np.stack([dx / 2, dx / 2, -dx / 2, -dx / 2], -1)
    oy = np.stack([dy / 2, -dy / 2, -dy / 2, dy / 2], -1)
    rx = ox * c[..., None] - oy * s[..., None]
    ry = ox * s[..., None] + oy * c[..., None]
    return np.stack([cx[..., None] + rx, cy[..., None] + ry], -1)


def _poly_area(p: np.ndarray) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def _clip_poly(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman intersection of convex polygons [M, 2]."""
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = (b[0] - a[0], b[1] - a[1])
        inp, out = out, []
        if not inp:
            break
        prev = inp[-1]
        pin = edge[0] * (prev[1] - a[1]) - edge[1] * (prev[0] - a[0]) <= 0
        for cur in inp:
            cin = edge[0] * (cur[1] - a[1]) - edge[1] * (cur[0] - a[0]) <= 0
            if cin != pin:
                d = (cur[0] - prev[0], cur[1] - prev[1])
                denom = edge[0] * d[1] - edge[1] * d[0]
                t = (
                    (edge[1] * (prev[0] - a[0]) - edge[0] * (prev[1] - a[1]))
                    / denom
                ) if denom else 0.0
                out.append(
                    (prev[0] + t * d[0], prev[1] + t * d[1])
                )
            if cin:
                out.append(tuple(cur))
            prev, pin = cur, cin
    return np.asarray(out, np.float64).reshape(-1, 2)


def rotated_iou_bev(box_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """IoU of one rotated BEV box [5] against [N, 5] (cx, cy, dx, dy, yaw)."""
    ca = _box_corners_bev(*[np.asarray(box_a[i]) for i in range(5)])
    area_a = float(box_a[2] * box_a[3])
    ious = np.zeros(len(boxes_b))
    for n, bb in enumerate(boxes_b):
        cb = _box_corners_bev(*[np.asarray(bb[i]) for i in range(5)])
        inter_poly = _clip_poly(ca, cb)
        inter = _poly_area(inter_poly) if len(inter_poly) >= 3 else 0.0
        union = area_a + float(bb[2] * bb[3]) - inter
        ious[n] = inter / union if union > 0 else 0.0
    return ious


def nms_rotated_bev(
    bev: np.ndarray, scores: np.ndarray, labels: np.ndarray,
    iou_thr: float = 0.05, score_thr: float = 0.01, max_num: int = 500,
) -> np.ndarray:
    """Per-class greedy rotated NMS (the reference's
    `box3d_multiclass_nms` call at `:320-341` with its nms_cfg: nms_thr
    0.05, score_thr 0.01, max_per_frame 500). Returns kept indices."""
    keep: List[int] = []
    for cls in np.unique(labels):
        idx = np.where((labels == cls) & (scores > score_thr))[0]
        idx = idx[np.argsort(-scores[idx])]
        alive = list(idx)
        while alive:
            i = alive.pop(0)
            keep.append(i)
            if alive:
                ious = rotated_iou_bev(bev[i], bev[alive])
                alive = [a for a, v in zip(alive, ious) if v <= iou_thr]
    keep = sorted(keep, key=lambda i: -scores[i])[:max_num]
    return np.asarray(keep, np.int64)


def mono_boxes_to_global(det: Dict, info: Dict) -> Dict[str, np.ndarray]:
    """Camera-frame detections -> global frame.

    det: {boxes_3d [N, 9] camera frame (gravity center, dims (dx, dy, dz),
    yaw about -y, velocity (vx, vz))}, info: image record with cam2ego_/
    ego2global_ quaternions. Mirrors `output_to_nusc_box` +
    `cam_nusc_box_to_global` (reference `:632-712`): nusc wlh =
    dims[[2, 0, 1]], box orientation = Rx(pi/2) @ Rz(-yaw) composed with
    the two extrinsics, velocity (vx, 0, vz) rotated along; the ego-frame
    xy-radius class filter is the caller's job (needs labels)."""
    boxes = np.asarray(det["boxes_3d"], np.float64).reshape(-1, 9)
    r_c2e = quat_to_rot(np.asarray(info["cam2ego_rotation"], np.float64))
    t_c2e = np.asarray(info["cam2ego_translation"], np.float64)
    r_e2g = quat_to_rot(np.asarray(info["ego2global_rotation"], np.float64))
    t_e2g = np.asarray(info["ego2global_translation"], np.float64)

    center_ego = boxes[:, :3] @ r_c2e.T + t_c2e
    center = center_ego @ r_e2g.T + t_e2g
    wlh = boxes[:, [5, 3, 4]]
    vel_cam = np.stack(
        [boxes[:, 7], np.zeros(len(boxes)), boxes[:, 8]], -1
    )
    vel = vel_cam @ (r_e2g @ r_c2e).T

    rx = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)  # Rx(pi/2)
    quats, yaws = [], []
    for b in boxes:
        cy, sy = np.cos(-b[6]), np.sin(-b[6])
        rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float64)
        rg = r_e2g @ r_c2e @ rx @ rz
        quats.append(_rot_to_quat(rg))
        yaws.append(np.arctan2(rg[1, 0], rg[0, 0]))
    return dict(
        center=center,
        center_ego=center_ego,
        wlh=wlh,
        vel=vel,
        quat=np.asarray(quats).reshape(-1, 4),
        yaw=np.asarray(yaws, np.float64),
    )


def format_mono_results(
    images: Sequence[Dict],
    results: Sequence[Dict],
    num_cams: int = 6,
    meta: Optional[Dict] = None,
) -> Dict:
    """Per-camera mono detections -> nuScenes submission dict.

    The reference's `_format_bbox` (`:275-380`): every `num_cams`
    consecutive images form one sample; their detections are lifted to
    global, ego-distance-filtered per class, merged, deduplicated with
    rotated BEV NMS across cameras, and written with `get_attr_name`
    attributes. results: per image {boxes_3d [N, 9] camera frame,
    scores_3d, labels_3d, attrs_3d (optional)}."""
    nusc_annos: Dict[str, List[Dict]] = {}
    for start in range(0, len(results), num_cams):
        frame = slice(start, min(start + num_cams, len(results)))
        token = images[start]["token"]
        g_center, g_wlh, g_vel, g_quat, g_yaw = [], [], [], [], []
        scores, labels, attrs = [], [], []
        for img, det in zip(images[frame], results[frame]):
            n = len(np.asarray(det["boxes_3d"]).reshape(-1, 9))
            if n == 0:
                continue
            g = mono_boxes_to_global(det, img)
            lab = np.asarray(det["labels_3d"], np.int64)
            # ego-frame xy-radius filter per class (reference `:700-705`)
            radius = np.linalg.norm(g["center_ego"][:, :2], axis=1)
            rng = np.asarray([CLASS_RANGE[CLASS_NAMES[l]] for l in lab])
            m = radius <= rng
            g_center.append(g["center"][m])
            g_wlh.append(g["wlh"][m])
            g_vel.append(g["vel"][m])
            g_quat.append(g["quat"][m])
            g_yaw.append(g["yaw"][m])
            scores.append(np.asarray(det["scores_3d"], np.float64)[m])
            labels.append(lab[m])
            a = det.get("attrs_3d")
            attrs.append(
                np.asarray(a, np.int64)[m]
                if a is not None
                else np.full(int(m.sum()), 8, np.int64)
            )
        annos: List[Dict] = []
        if scores and sum(len(s) for s in scores):
            center = np.concatenate(g_center)
            wlh = np.concatenate(g_wlh)
            vel = np.concatenate(g_vel)
            quat = np.concatenate(g_quat)
            yaw = np.concatenate(g_yaw)
            sc = np.concatenate(scores)
            lb = np.concatenate(labels)
            at = np.concatenate(attrs)
            # cross-camera dedup: rotated NMS in the global BEV plane
            # (see module docstring for the frame choice)
            bev = np.stack(
                [center[:, 0], center[:, 1], wlh[:, 1], wlh[:, 0], yaw], -1
            )
            keep = nms_rotated_bev(bev, sc, lb)
            for i in keep:
                name = CLASS_NAMES[int(lb[i])]
                annos.append(
                    dict(
                        sample_token=token,
                        translation=center[i].tolist(),
                        size=wlh[i].tolist(),
                        rotation=quat[i].tolist(),
                        velocity=vel[i, :2].tolist(),
                        detection_name=name,
                        detection_score=float(sc[i]),
                        attribute_name=get_attr_name(at[i], name),
                    )
                )
        nusc_annos.setdefault(token, []).extend(annos)
    return dict(
        meta=meta
        or dict(
            use_camera=True, use_lidar=False, use_radar=False,
            use_map=False, use_external=False,
        ),
        results=nusc_annos,
    )
