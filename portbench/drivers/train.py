"""`Trainer.step` after `Trainer.step` on a pool of seeded samples cycled
in order, each step ending with its losses on the host.

Traffic (`portbench/traffic/<name>.json`): `pool` samples of the
configuration's queue (three history frames and the trained one at batch
1), noise images, six radial cameras, an ego trajectory packed as the
dataset packs it, `gt_boxes` boxes each; sample `scene_break[0]` starts a
new scene at its frame `scene_break[1]`. The learning-rate schedule runs
over `total_steps` (24 epochs of nuScenes' 28,130 training samples at 8
cards of batch 1).

The check (`portbench/workloads/<cell>.json`, `check`): set-up builds one
`Trainer` and drives it through the first `steps` steps, on samples that
all differ; the window continues with that same object, and `window_steps`
more steps drawn from the seed among its first `within` are checked too.
For each checked step the harness keeps the program's trainable parameters
and AdamW moments as the step found them, the step's dropout and GridMask
draws and its head outputs, and, from the state the step left, each leaf's
clipped gradient as AdamW received it (worked out from its first moment)
and each leaf's change. After the window the reference takes each checked
step from the state the program's step found (the first from the seed's
weights, made again), with the same draws, its queries matched on the
program's head outputs of the step (the Hungarian match is discrete: a
match worked out from the reference's own outputs, a rounding away, may
pick another query; the loss so matched is reported beside it).
Compared, each the largest over the checked steps: the trained frame's
head outputs over every decoder layer (`head_gap`, ||program -
reference|| / ||reference||), the loss (`loss_gap`, relative), for each
group of leaves (`GROUPS`) its median leaf's |program's gradient norm -
reference's| over the larger of the reference's norm of that leaf and of
the step's median leaf (`grad_gap.<group>`) and its worst leaf's
(`grad_worst.<group>`), and the same of each leaf's change, the worst leaf
(`change_gap`), leaving out the leaves whose
reference gradient is under a thousandth of the median leaf's (a key's bias
under softmax moves by round-off alone). Numbers without a limit in the
cell's file are logged, not compared. Which are compared, and why: PERF.md.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import program, traffic, weights
from portbench.harness import Clock, rel_gap, tf32_flags
from portbench.reference import model as ref
from portbench.reference import train as ref_train

POOL_SALT = 2000
SAMPLE_SALT = 200
TRAINER_SALT = 3
PICK_SALT = 6
BETA1 = 0.9  # AdamW's first-moment decay in both sides
HEADS = ("all_cls_scores", "all_bbox_preds")
# leaf groups, the first that matches: the DCN layers' weights
# ("dcn_weight") and offset convolutions ("dcn_offset"), then by name
# prefix; the rest (embeddings, positional encoding, the can-bus MLP) is
# "embed"
GROUPS = (("backbone", ("img_backbone.",)), ("neck", ("img_neck.",)),
          ("encoder", ("pts_bbox_head.transformer.encoder.",)),
          ("decoder", ("pts_bbox_head.transformer.decoder.",)),
          ("head", ("pts_bbox_head.cls_branches.", "pts_bbox_head.reg_branches.")))


def leaf_groups(model: ref.Detector) -> Dict[str, str]:
    """Parameter name -> its group (`GROUPS`, the DCN layers' first,
    "embed" last)."""
    dcn = {f"{m}.{n}": "dcn_weight" if n == "weight" else "dcn_offset"
           for m, mod in model.named_modules() if isinstance(mod, ref.DeformConv)
           for n, _ in mod.named_parameters()}
    return {name: dcn.get(name) or next((g for g, prefixes in GROUPS
                                         if name.startswith(prefixes)), "embed")
            for name, _ in model.named_parameters()}


class _Doubled(torch.autograd.Function):
    """The identity, its gradient doubled."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


class Driver:
    unit = "step"

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        self.cfg = ref.config(cell.config)
        t = cell.traffic
        self.pool_size, self.total_steps = int(t["pool"]), int(t["total_steps"])
        spec = cell.spec["check"]
        self.check_steps = int(spec["steps"])
        rng = np.random.RandomState(traffic.seed32(seed, PICK_SALT))
        self.check_at = {int(k) for k in rng.choice(
            np.arange(self.check_steps, self.check_steps + int(spec["within"])),
            int(spec["window_steps"]), replace=False)}

    def sample(self, k: int) -> Dict[str, torch.Tensor]:
        """Training sample `k` of the pool, as `runtime.train.Batch`'s
        fields."""
        c, t, dev = self.cfg, self.cell.traffic, self.device
        frames, cams = c.data.queue_length, c.data.num_cams
        h, w = ref.img_size(c)
        rng = np.random.RandomState(traffic.seed32(self.seed, SAMPLE_SALT, k))
        brk = t["scene_break"]
        can, prev_exists = traffic.train_queue(rng, frames, brk[1] if k == brk[0] else None)
        boxes, labels = traffic.gt_boxes(rng, int(t["gt_boxes"]), c.max_gt)
        images = torch.empty((1, frames, cams, h, w, 3), device=dev)
        for f in range(frames):
            gen = traffic.generator(self.seed, POOL_SALT + k * frames + f, dev)
            images[0, f] = traffic.noise_images(1, cams, h, w, c.data.mean, c.data.std, gen, dev)[0]
        raw = int(c.data.raw_size[0] * c.data.scale), int(c.data.raw_size[1] * c.data.scale)
        l2i = traffic.rig_lidar2img(raw[1], raw[0], cams)

        def t_(a, dtype):
            return torch.as_tensor(np.array(a)[None], dtype=dtype, device=dev)

        return dict(images=images, can_bus=t_(can, torch.float32),
                    lidar2img=t_(np.broadcast_to(l2i, (frames,) + l2i.shape), torch.float32),
                    prev_exists=t_(prev_exists, torch.bool), gt_boxes=t_(boxes, torch.float32),
                    gt_labels=t_(labels, torch.int64),
                    num_gt=torch.tensor([int(t["gt_boxes"])], device=dev))

    # ------------------------------------------------------------ program
    def setup(self):
        dev = self.device
        clock = Clock(dev)
        self.pool = [program.train_batch(**self.sample(k)) for k in range(self.pool_size)]
        clock.lap("pool")
        self.model = program.build_model(program.port_config(self.cell.config),
                                         weights.make(self.cfg, self.seed, dev), dev)
        self.trainer = program.trainer(self.model, self.total_steps,
                                       traffic.seed32(self.seed, TRAINER_SALT))
        clock.lap("model")
        if self.fault == "stale":  # a step that leaves the state as it found it
            self.trainer.optimizer.step = lambda *a, **k: None
        if self.fault == "dx":  # the DCN layers' input gradient doubled where it is made
            self._plant_dx()
        if self.fault == "dw":  # the DCN layers' weight gradient doubled where it is made
            for mod in self.model.modules():
                if type(mod).__name__ == "ModulatedDeformConv":
                    mod.weight.register_hook(lambda g: g * 2.0)
        self.trained = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.records: List[Dict] = []
        for k in range(self.check_steps):
            self.checked_step(k)
        clock.lap("checked steps")
        self.next = self.check_steps
        self.setup_phases = clock.laps

    def _plant_dx(self):
        from bevformer_torch.models import resnet

        dcn_conv = resnet.dcn_conv
        self._restore = lambda: setattr(resnet, "dcn_conv", dcn_conv)
        resnet.dcn_conv = lambda x, *a, **k: dcn_conv(_Doubled.apply(x), *a, **k)

    def moments(self):
        """The AdamW moments of each trained leaf (zeros before its first
        step)."""
        state = self.trainer.optimizer.state
        m = [state[p]["exp_avg"] if p in state else torch.zeros_like(p) for _, p in self.trained]
        v = [state[p]["exp_avg_sq"] if p in state else torch.zeros_like(p) for _, p in self.trained]
        return m, v

    def checked_step(self, k: int) -> None:
        """Step `k`, keeping what the reference needs to take the same step
        and what it is compared with."""
        params = [p.detach() for _, p in self.trained]
        m, v = self.moments()
        before = dict(params=[t.clone() for t in params], m=[t.clone() for t in m],
                      v=[t.clone() for t in v])
        masks, grid, heads = [], [], []
        hooks = [mod.register_forward_hook(self._keeper(masks)) for mod in self.model.modules()
                 if isinstance(mod, torch.nn.Dropout)]
        hooks.append(self.model.grid_mask.register_forward_hook(
            lambda mod, a, out: grid.append(out != 0)))
        hooks.append(self.model.pts_bbox_head.register_forward_hook(
            lambda mod, a, out: heads.append({h: out[h].detach().clone() for h in HEADS})
            if isinstance(out, dict) else None))  # the history frames return their BEV
        try:
            loss = self.step_on(k)
        finally:
            for h in hooks:
                h.remove()
        m_after, _ = self.moments()
        grad = torch._foreach_sub(m_after, torch._foreach_mul(before["m"], BETA1))
        torch._foreach_div_(grad, 1.0 - BETA1)
        change = torch._foreach_sub(params, before["params"])
        names = [n for n, _ in self.trained]
        grad_n = torch.stack(torch._foreach_norm(grad)).tolist()
        change_n = torch.stack(torch._foreach_norm(change)).tolist()
        del grad, change
        if k == 0:  # the reference starts from the seed's weights, made again
            before = None
        elif k < self.check_steps:  # set-up: off the card until the check
            before = {key: host_copy(ts) for key, ts in before.items()}
        self.records.append(dict(
            k=k, loss=loss, head=heads[0], draws=ref.Draws(masks, grid[0] if grid else None),
            state=before and {key: dict(zip(names, ts)) for key, ts in before.items()},
            grad=dict(zip(names, grad_n)), change=dict(zip(names, change_n))))

    @staticmethod
    def _keeper(masks):
        def hook(module, args, out):
            if module.training and module.p > 0:
                masks.append(out != 0)
        return hook

    def step_on(self, k: int) -> float:
        loss = self.trainer.step(self.pool[k % self.pool_size])["total"]
        return loss * 1.5 if self.fault == "alter" else loss

    def step(self):
        if self.next in self.check_at:
            self.checked_step(self.next)
        else:
            self.step_on(self.next)
        self.next += 1

    def release(self):
        if self.fault == "dx":
            self._restore()
        del self.trainer, self.model, self.pool

    # ------------------------------------------------------------ check
    def reference_model(self):
        m = weights.reference_skeleton(self.cfg)
        m.to_empty(device=self.device)
        m.load_state_dict(weights.make(self.cfg, self.seed, self.device))
        return m

    def follow(self, m: ref.Detector, rec: Dict, match_on: Optional[Dict]) -> Dict:
        """The reference's step `rec["k"]` from the state that step found
        (the first from the seed's weights, as `m` holds them), with its
        draws, matched on `match_on` (None: on its own outputs)."""
        dev = self.device
        opt = ref_train.AdamW(m, self.cfg, self.total_steps)
        opt.t = rec["k"]
        state = rec["state"]
        if rec["k"] > 0:
            with torch.no_grad():
                for n, p, _ in opt.params:
                    p.copy_(state["params"][n].to(dev))
                    opt.m[n].copy_(state["m"][n].to(dev))
                    opt.v[n].copy_(state["v"][n].to(dev))
        start = {n: p.detach().clone() for n, p, _ in opt.params}
        batch = self.sample(rec["k"] % self.pool_size)
        loss, grads, head, own = ref_train.train_step(m, opt, batch, rec["draws"], match_on)
        change = {n: float((p.detach() - start[n]).norm()) for n, p, _ in opt.params}
        return dict(loss=loss, loss_own_match=own, grad={n: float(g.norm()) for n, g in grads.items()},
                    change=change, head=head)

    def control_records(self) -> List[Dict]:
        """The reference in TF32 in the program's place: its own steps from
        the seed, with the program's draws, matched on its own outputs."""
        m = self.reference_model()
        opt = ref_train.AdamW(m, self.cfg, self.total_steps)
        out = []
        for rec in self.records[:self.check_steps]:
            k = rec["k"]
            state = {key: {n: t.detach().clone() for n, t in d.items()} for key, d in (
                ("params", {n: p for n, p, _ in opt.params}), ("m", opt.m), ("v", opt.v))}
            with tf32_flags(True):
                loss, grads, head, _ = ref_train.train_step(m, opt, self.sample(k % self.pool_size),
                                                            rec["draws"])
            change = {n: float((p.detach() - state["params"][n]).norm()) for n, p, _ in opt.params}
            out.append(dict(k=k, loss=loss, head=head, draws=rec["draws"], state=state,
                            grad={n: float(g.norm()) for n, g in grads.items()}, change=change))
        del m, opt
        return out

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared, the largest over the checked steps. With
        `control`, the reference in TF32 takes the program's place for the
        set-up's steps."""
        recs = self.control_records() if control else self.records
        m = self.reference_model()
        groups = leaf_groups(m)
        numbers: Dict[str, float] = {}
        self.details = []
        for rec in recs:
            with tf32_flags(False):
                want = self.follow(m, rec, rec["head"])
            step = compare(rec, want, groups)
            for key, value in step.pop("numbers").items():
                numbers[key] = max(numbers.get(key, 0.0), value)
            self.details.append(step)
        return numbers


def host_copy(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors on the host, in one copy."""
    flat = torch.cat([t.reshape(-1) for t in ts]).cpu()
    return [c.view(t.shape) for c, t in zip(flat.split([t.numel() for t in ts]), ts)]


def compare(rec: Dict, want: Dict, groups: Dict[str, str]) -> Dict:
    """One step's numbers and what the look needs."""
    grads = want["grad"]
    median_g = float(np.median(list(grads.values())))
    g_gaps = {n: abs(rec["grad"].get(n, 0.0) - g) / max(g, median_g) for n, g in grads.items()}
    moving = [n for n in want["change"] if grads.get(n, 0.0) >= 1e-3 * median_g]
    median_c = float(np.median([want["change"][n] for n in moving]))
    c_gaps = {n: abs(rec["change"][n] - want["change"][n]) / max(want["change"][n], median_c)
              for n in moving}
    numbers = dict(head_gap=max(rel_gap(rec["head"][h], want["head"][h]) for h in HEADS),
                   loss_gap=abs(rec["loss"] - want["loss"]) / abs(want["loss"]),
                   change_gap=max(c_gaps.values()))
    worst = {}
    for g in sorted(set(groups.values())):
        gaps = {n: v for n, v in g_gaps.items() if groups[n] == g}
        if not gaps:
            continue
        numbers[f"grad_gap.{g}"] = float(np.median(list(gaps.values())))
        n = max(gaps, key=gaps.get)
        numbers[f"grad_worst.{g}"] = gaps[n]
        worst[g] = (n, gaps[n], rec["grad"].get(n, 0.0), grads[n])
    n = max(c_gaps, key=c_gaps.get)
    return dict(k=rec["k"], numbers=numbers, losses=[rec["loss"], want["loss"], want["loss_own_match"]],
                grad_worst=worst, change_worst=(n, c_gaps[n], rec["change"][n], want["change"][n]),
                head_layers=[[rel_gap(p, w) for p, w in zip(rec["head"][h], want["head"][h])]
                             for h in HEADS])
