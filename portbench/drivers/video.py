"""One video stream through `VideoEvaluator.step` (v1) or
`VideoEvaluatorV2.step` (V2), frame after frame, each frame's decoded boxes
copied to the host before the next is sent: a closed loop.

Traffic (`portbench/traffic/<name>.json`): scenes of `scene_frames`
frames replayed from a pool of that many frames made on the device in
set-up, each replay on a new ego trajectory (3-8 m/s, 0.05 rad a frame,
0.5 s apart) drawn from the seed; six radial cameras. v1 carries the BEV
from frame to frame of a scene and starts each scene without it. A V2
sample at scene frame t holds the frames t + offset of `frames` (an offset
before the scene's start takes frame t's images and cameras); a history
frame's cameras map the current frame's lidar coordinates through both ego
poses.

The check (`portbench/workloads/<cell>.json`, `check`): the window's first
frame, which starts a scene, and `frames - 1` more drawn from the seed,
are computed again by the reference from the same inputs, a v1 frame with
the program's carried BEV as its history. Compared: the BEV as carried
(`bev_gap`), the last decoder layer's class logits (`cls_gap`) and box
code (`reg_gap`) (each ||program - reference|| / ||reference||), and the
decoded boxes on the host against the reference's decode of the program's
head outputs (`decode_gap`, an exact comparison: the largest difference of
a score or a box value, infinite where a label differs). The reference's
own decode is not compared: at seeded weights the decoder's last layer
carries the program's rounding multiplied (PERF.md), and near-equal scores
trade places in the top-k.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import program, traffic, weights
from portbench.harness import Clock, rel_gap, tf32_flags
from portbench.reference import model as ref
from portbench.reference import ops

V2_CROP_TOP = 260  # the V2 pipeline's crop (0, 260, 1600, 900) of a nuScenes camera
POOL_SALT = 1000
POSE_SALT = 100
PICK_SALT = 5
DECODED = ("bboxes", "scores", "labels", "valid")
HEADS = ("all_cls_scores", "all_bbox_preds")  # [decoder layers, 1, queries, C]


class Driver:
    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.cfg = ref.config(cell.config)
        self.v2 = self.cfg.version == "v2"
        self.unit = "sample" if self.v2 else "frame"
        self.frames = int(cell.traffic["scene_frames"])
        self.captures: List[Dict] = []
        self.rig = self.rig_lidar2img()
        self._poses = (None, None, None)

    # ------------------------------------------------------------ inputs
    def image_shape(self):
        h, w = ref.img_size(self.cfg)
        return self.cfg.data.num_cams, h, w

    def frame_images(self, k: int) -> torch.Tensor:
        cams, h, w = self.image_shape()
        d = self.cfg.data
        gen = traffic.generator(self.seed, POOL_SALT + k, self.device)
        return traffic.noise_images(1, cams, h, w, d.mean, d.std, gen, self.device)[0]

    def rig_lidar2img(self) -> np.ndarray:
        d = self.cfg.data
        if self.v2:
            return traffic.rig_lidar2img(d.raw_size[1], d.raw_size[0] + V2_CROP_TOP, d.num_cams,
                                         crop_top=V2_CROP_TOP)
        h, w = int(d.raw_size[0] * d.scale), int(d.raw_size[1] * d.scale)
        return traffic.rig_lidar2img(w, h, d.num_cams)

    def poses(self, replay: int):
        """(positions, yaws, speed) of the replay's ego trajectory."""
        if self._poses[0] != replay:
            rng = np.random.RandomState(traffic.seed32(self.seed, POSE_SALT, replay))
            pos, yaw, speed = traffic.scene_poses(rng, self.frames)
            self._poses = (replay, (pos, yaw, speed), traffic.can_bus_deltas(pos, yaw, speed))
        return self._poses[1]

    def frame_inputs(self, replay: int, pos: int):
        """v1: (can_bus [1, 18], lidar2img [1, cams, 4, 4]); V2: (frame
        indices, lidar2img [1, T, cams, 4, 4])."""
        pos_xyz, yaw, speed = self.poses(replay)
        rig = self.rig
        if not self.v2:
            can = self._poses[2][pos]
            return (torch.as_tensor(can, dtype=torch.float32, device=self.device)[None],
                    torch.as_tensor(rig, dtype=torch.float32, device=self.device)[None])
        idx, l2i = [], []
        for off in self.cfg.frames:
            t = pos + off
            if off == 0 or t < 0:
                idx.append(pos)
                l2i.append(rig)
            else:
                idx.append(t)
                l2i.append(traffic.history_lidar2img(rig, traffic.ego_pose(pos_xyz[pos], yaw[pos]),
                                                     traffic.ego_pose(pos_xyz[t], yaw[t])))
        return idx, torch.as_tensor(np.stack(l2i), dtype=torch.float32, device=self.device)[None]

    # ------------------------------------------------------------ program
    def setup(self):
        dev = self.device
        clock = Clock(dev)
        cams, h, w = self.image_shape()
        self.pool = torch.empty((self.frames, cams, h, w, 3), device=dev)
        for k in range(self.frames):
            self.pool[k] = self.frame_images(k)
        clock.lap("pool")
        self.model = program.build_model(program.port_config(self.cell.config),
                                         weights.make(self.cfg, self.seed, dev), dev)
        self.evaluator = program.video_evaluator(self.model.cfg, self.model)
        clock.lap("model")
        self.head_out = None
        self.model.pts_bbox_head.register_forward_hook(self._keep_head)
        self.flip = torch.zeros((1,), dtype=torch.bool, device=dev)
        self.bda = torch.eye(2, device=dev)[None]
        # warm up on a scene of its own: a frame without history and one with
        self.replay, self.pos, self.i = -1, 0, 0
        self.check_at = set()
        for _ in range(2):
            self.step()
        clock.lap("warm-up")
        self.setup_phases = clock.laps
        spec = self.cell.spec["check"]
        rng = np.random.RandomState(traffic.seed32(self.seed, PICK_SALT))
        picks = rng.choice(np.arange(1, int(spec["within"])), int(spec["frames"]) - 1,
                           replace=False)
        self.check_at = {0, *map(int, picks)}
        self.replay, self.pos, self.i = 0, 0, 0

    def _keep_head(self, module, args, output):
        self.head_out = output

    def step(self):
        if self.pos == 0:
            self.prev_bev = torch.zeros((1, self.cfg.bev_h * self.cfg.bev_w, self.cfg.embed_dims),
                                        device=self.device)
        capture = self.i in self.check_at
        if self.v2:
            idx, l2i = self.frame_inputs(self.replay, self.pos)
            preds, dec = self.evaluator.step(self.pool[idx][None], l2i, self.flip, self.bda)
            bev = preds["bev_embed"]
        else:
            can, l2i = self.frame_inputs(self.replay, self.pos)
            has = torch.tensor([self.pos > 0], device=self.device)
            prev = self.prev_bev
            bev, dec = self.evaluator.step(self.pool[self.pos][None], can, l2i, prev, has)
            if self.fault == "stale":  # the step hands back the state it was given
                bev = prev
        host = {k: dec[k][0].cpu() for k in DECODED}
        if self.fault == "alter":  # an answer altered where it is produced: a box 1 m off
            host["bboxes"][0, 0] += 1.0
        if capture:
            head = self.head_out
            self.captures.append(dict(
                replay=self.replay, pos=self.pos, host=host, bev=bev.clone(),
                prev=None if self.v2 or self.pos == 0 else self.prev_bev.clone(),
                heads={k: head[k].clone() for k in HEADS}))
        if not self.v2:
            self.prev_bev = bev.float()
        self.i += 1
        self.pos += 1
        if self.pos == self.frames:
            self.pos, self.replay = 0, self.replay + 1

    def release(self):
        del self.evaluator, self.model, self.pool, self.prev_bev, self.head_out

    # ------------------------------------------------------------ check
    def reference(self) -> ref.Detector:
        m = weights.reference_skeleton(self.cfg)
        m.to_empty(device=self.device)
        m.load_state_dict(weights.make(self.cfg, self.seed, self.device))
        return m.eval()

    @torch.no_grad()
    def reference_outputs(self, m: ref.Detector, cap: Dict) -> Dict:
        if self.v2:
            idx, l2i = self.frame_inputs(cap["replay"], cap["pos"])
            images = torch.stack([self.frame_images(k) for k in idx])[None]
            return m.forward_v2(images, l2i, torch.eye(2, device=self.device)[None])
        can, l2i = self.frame_inputs(cap["replay"], cap["pos"])
        prev = cap["prev"]
        if prev is None:
            prev = torch.zeros((1, self.cfg.bev_h * self.cfg.bev_w, self.cfg.embed_dims),
                               device=self.device)
        has = torch.tensor([cap["pos"] > 0], device=self.device)
        return m.forward_v1(self.frame_images(cap["pos"])[None], can, l2i, prev, has)

    def decode(self, cls, reg) -> Dict:
        c = self.cfg
        return ops.decode(cls[0], reg[0], c.max_num, c.num_classes, c.post_center_range)

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared, the largest over the checked frames. With
        `control`, the reference in TF32 takes the program's place."""
        m = self.reference()
        gaps = dict(bev_gap=0.0, cls_gap=0.0, reg_gap=0.0, decode_gap=0.0)
        self.details = []
        for cap in self.captures:
            with tf32_flags(False):
                want = self.reference_outputs(m, cap)
            if control:
                with tf32_flags(True):
                    got = self.reference_outputs(m, cap)
                heads = {k: got[k] for k in HEADS}
                cap = dict(cap, bev=got["bev_embed"], heads=heads, host={
                    k: v.cpu() for k, v in self.decode(*(heads[k][-1] for k in HEADS)).items()})
            else:  # how the gaps grow over the decoder's layers
                self.details.append(dict(pos=cap["pos"], bev=rel_gap(cap["bev"], want["bev_embed"]),
                                         layers=[[rel_gap(p, w) for p, w in zip(cap["heads"][k], want[k])]
                                                 for k in HEADS]))
            cls, reg = (cap["heads"][k][-1] for k in HEADS)
            gaps["bev_gap"] = max(gaps["bev_gap"], rel_gap(cap["bev"], want["bev_embed"]))
            gaps["cls_gap"] = max(gaps["cls_gap"], rel_gap(cls, want["all_cls_scores"][-1]))
            gaps["reg_gap"] = max(gaps["reg_gap"], rel_gap(reg, want["all_bbox_preds"][-1]))
            gaps["decode_gap"] = max(gaps["decode_gap"], decode_gap(cap["host"], self.decode(cls, reg)))
        return gaps


def decode_gap(host: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The largest difference of a decoded score or box value (infinite
    where a label or a box's validity differs)."""
    want = {k: v.cpu() for k, v in want.items()}
    if not (torch.equal(host["labels"], want["labels"]) and torch.equal(host["valid"], want["valid"])):
        return float("inf")
    gap = 0.0
    for k in ("bboxes", "scores"):
        d = (host[k].double() - want[k].double()).abs()
        gap = max(gap, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return gap
