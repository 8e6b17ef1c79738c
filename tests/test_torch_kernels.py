"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no jax (nor does `tests/torch_port_helpers.py`), so it
also runs on a machine without it, from the repo root:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: msda 1e-5 absolute on N(0, 1) values (same corners, sums in
another order; the pixel position rounds as in the plain version); DCN 1e-5
of the output's scale (fp32 sums of 9*C products in another order). The
backward kernels: 1e-5 of each gradient's scale (the same corners; sums over
channels and atomic adds in another order, so dValue and dx are not bitwise
deterministic from run to run).
"""

import numpy as np
import pytest
import torch

from bevformer_torch.kernels import dcn, msda
# by module name, not as `tests.torch_port_helpers`: pytest puts this
# directory on sys.path, and another installed `tests` package would shadow
# the repo's on a machine that has one
from torch_port_helpers import assert_close, t

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, with TF32 off for fp32 matmuls and convolutions (restored
    afterwards)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


MSDA_CASES = [
    # name, B, Q, H, D, spatial shapes, P
    ("tsa", 2, 96, 8, 32, ((8, 12),), 4),
    ("sca", 6, 40, 8, 32, ((12, 20), (6, 10), (3, 5), (2, 3)), 8),
    ("decoder", 1, 30, 8, 32, ((10, 10),), 4),
    ("wide_head", 1, 13, 3, 64, ((5, 7), (3, 4)), 3),
]


def _msda_inputs(b, q, h, d, shapes, p, seed, device):
    rng = np.random.RandomState(seed)
    k = sum(hh * ww for hh, ww in shapes)
    value = rng.randn(b, k, h, d).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (b, q, h, len(shapes), p, 2)).astype(np.float32)
    logits = rng.randn(b, q, h, len(shapes) * p)
    attw = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    attw = attw.reshape(b, q, h, len(shapes), p)
    return [t(a).to(device) for a in (value, loc, attw)]


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", MSDA_CASES, ids=[c[0] for c in MSDA_CASES])
def test_msda_kernel_matches_plain(cuda_device, name, b, q, h, d, shapes, p):
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, len(name), cuda_device)
    before = msda.ms_deform_attn.launches
    out = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn.launches == before + 1
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    assert float((out - ref).abs().max()) <= 1e-5, name


def _dcn_inputs(seed, device, b=3, h=13, w=21, c=64, cout=96, stride=1):
    rng = np.random.RandomState(seed)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, c).astype(np.float32)
    off_y = (rng.randn(b, oh, ow, 9) * 3).astype(np.float32)
    off_x = (rng.randn(b, oh, ow, 9) * 3).astype(np.float32)
    mask = rng.rand(b, oh, ow, 9).astype(np.float32)
    weight = (rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(np.float32)
    return [t(a).to(device) for a in (x, off_y, off_x, mask, weight)]


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_kernel_matches_plain(cuda_device, stride):
    args = _dcn_inputs(3, cuda_device, stride=stride)
    before = dcn.dcn_conv.launches
    out = dcn.dcn_conv(*args, stride)
    torch.cuda.synchronize()
    assert dcn.dcn_conv.launches == before + 1
    assert_close(out, dcn.dcn_conv_plain(*args, stride), 1e-5, f"stride {stride}")


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", MSDA_CASES, ids=[c[0] for c in MSDA_CASES])
def test_msda_backward_kernel_matches_plain(cuda_device, name, b, q, h, d, shapes, p):
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 7 + len(name), cuda_device)
    g = torch.randn((b, q, h * d), device=cuda_device)
    before = msda.ms_deform_attn_backward.launches
    grads = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn_backward.launches == before + 1
    ref = msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g)
    for what, a, r in zip(("dvalue", "dloc", "dattw"), grads, ref):
        assert_close(a, r, 1e-5, f"{name} {what}")


def test_msda_autograd_runs_the_backward_kernel(cuda_device):
    """`ms_deform_attn` on CUDA tensors is differentiable: autograd calls
    the backward kernel, with a non-contiguous incoming gradient."""
    value, loc, attw = _msda_inputs(2, 40, 8, 32, ((6, 9), (3, 5)), 4, 1, cuda_device)
    leaves = [x.clone().requires_grad_() for x in (value, loc, attw)]
    before = msda.ms_deform_attn_backward.launches
    out = msda.ms_deform_attn(leaves[0], ((6, 9), (3, 5)), leaves[1], leaves[2])
    # a transpose downstream hands the backward a strided gradient
    (out.transpose(0, 1) * torch.arange(2.0, device=cuda_device)[:, None]).sum().backward()
    assert msda.ms_deform_attn_backward.launches == before + 1
    g = torch.arange(2.0, device=cuda_device)[:, None, None].expand(2, 40, 256).contiguous()
    ref = msda.ms_deform_attn_backward_plain(value, ((6, 9), (3, 5)), loc, attw, g)
    for what, leaf, r in zip(("dvalue", "dloc", "dattw"), leaves, ref):
        assert_close(leaf.grad, r, 1e-5, what)


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_im2col_kernel_matches_plain(cuda_device, stride):
    x, off_y, off_x, mask, _ = _dcn_inputs(4, cuda_device, stride=stride)
    before = dcn.dcn_im2col.launches
    cols = dcn.dcn_im2col(x, off_y, off_x, mask, stride)
    torch.cuda.synchronize()
    assert dcn.dcn_im2col.launches == before + 1
    assert_close(cols, dcn.dcn_im2col_plain(x, off_y, off_x, mask, stride), 1e-6, "cols")


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_col2im_kernel_matches_plain(cuda_device, stride):
    x, off_y, off_x, mask, _ = _dcn_inputs(5, cuda_device, stride=stride)
    dcols = torch.randn((off_y.numel() // 9, 9 * x.shape[3]), device=cuda_device)
    before = dcn.dcn_col2im.launches
    grads = dcn.dcn_col2im(x, off_y, off_x, mask, dcols, stride)
    torch.cuda.synchronize()
    assert dcn.dcn_col2im.launches == before + 1
    ref = dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols, stride)
    for what, a, r in zip(("dx", "doff_y", "doff_x", "dmask"), grads, ref):
        assert_close(a, r, 1e-5, f"stride {stride} {what}")


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_conv_backward_matches_plain(cuda_device, stride):
    """autograd through `dcn_conv` on CUDA tensors runs im2col and col2im
    once each and agrees with autograd through the plain version."""
    args = _dcn_inputs(6, cuda_device, stride=stride)
    leaves = [a.clone().requires_grad_() for a in args]
    counts = dcn.dcn_im2col.launches, dcn.dcn_col2im.launches
    out = dcn.dcn_conv(*leaves, stride)
    g = torch.randn(out.shape, device=cuda_device)
    # the NCHW permute of the model hands the backward a strided gradient
    out.permute(0, 3, 1, 2).backward(g.permute(0, 3, 1, 2))
    assert (dcn.dcn_im2col.launches, dcn.dcn_col2im.launches) == (counts[0] + 1, counts[1] + 1)
    ref = dcn.dcn_conv_backward_plain(*args, g, stride)
    for what, leaf, r in zip(("dx", "doff_y", "doff_x", "dmask", "dweight"), leaves, ref):
        assert_close(leaf.grad, r, 1e-5, f"stride {stride} {what}")


def test_wrappers_raise_on_cuda_input_they_cannot_take(cuda_device):
    """No fallback: a CUDA tensor the kernel cannot take raises."""
    value, loc, attw = _msda_inputs(1, 5, 8, 32, ((4, 5),), 2, 0, cuda_device)
    strided = loc.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, ((4, 5),), strided, attw)
    x, off_y, off_x, mask, weight = _dcn_inputs(0, cuda_device, c=48, cout=32)
    with pytest.raises(ValueError):
        dcn.dcn_conv(x, off_y, off_x, mask, weight, 1)


def test_mini_slice_kernel_path_matches_plain_path(cuda_device):
    """A mini bevformer_base (depth 10, 32x32 BEV, 2+2 layers) runs one
    video through the kernels and through the plain versions on the card."""
    from bevformer_torch.configs import DataConfig, get_config
    from bevformer_torch.data import SyntheticVideo
    from bevformer_torch.models import attention, resnet
    from bevformer_torch.runtime import VideoEvaluator, build_model, init_state_dict

    cfg = get_config("bevformer_base", backbone_depth=10, bev_h=32, bev_w=32,
                     encoder_layers=2, decoder_layers=2,
                     data=DataConfig(raw_size=(192, 320)))
    model = build_model(cfg, init_state_dict(cfg, seed=0), cuda_device)
    with torch.no_grad():  # small box refinements, as in chip_smoke.py
        for branch in model.pts_bbox_head.reg_branches:
            branch[-1].weight.mul_(0.1)
    video = SyntheticVideo(cfg, (2, 1), seed=0, device=cuda_device)

    def run():
        preds = []
        hook = model.register_forward_hook(lambda m, i, out: preds.append(out))
        VideoEvaluator(model).run(video, progress_every=0)
        hook.remove()
        return preds

    k1, k2 = msda.ms_deform_attn.launches, dcn.dcn_conv.launches
    ours = run()
    assert msda.ms_deform_attn.launches - k1 == 3 * (2 * 2 + 2)
    assert dcn.dcn_conv.launches - k2 == 3 * 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "ms_deform_attn", msda.ms_deform_attn_plain)
        mp.setattr(resnet, "dcn_conv", dcn.dcn_conv_plain)
        ref = run()
    for a, b in zip(ours, ref):
        for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
            assert_close(a[key], b[key], 1e-4, key)


def test_mini_train_step_kernel_path_matches_plain_path(cuda_device):
    """One eval-mode loss + backward of a mini bevformer_base (depth 10,
    32x32 BEV, 2+2 layers, queue 3) through the kernels and through the
    plain versions on the card: the loss to 1e-4 relative, and each
    parameter group's gradient to 1e-3 in relative L2 norm (a ReLU input or
    a bilinear sample within fp32 rounding of its switch moves one
    receptive field's gradient, so max-abs is no fair measure here). The
    reg branches' outputs are x0.1, as in chip_smoke.py."""
    from bevformer_torch.configs import DataConfig, get_config
    from bevformer_torch.data import train_batch
    from bevformer_torch.models import attention, resnet
    from bevformer_torch.runtime import build_model, init_state_dict, label_params, loss_fn

    cfg = get_config("bevformer_base", backbone_depth=10, bev_h=32, bev_w=32,
                     encoder_layers=2, decoder_layers=2, max_gt=32,
                     data=DataConfig(raw_size=(192, 320), queue_length=3))
    model = build_model(cfg, init_state_dict(cfg, seed=0), cuda_device)
    labels = label_params(model, cfg.optim.frozen_stages)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    with torch.no_grad():
        for branch in model.pts_bbox_head.reg_branches:
            branch[-1].weight.mul_(0.1)
    batch = train_batch(cfg, seed=0, device=cuda_device, scene_break_at=1)

    def run():
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(model.eval(), batch)
        total.backward()
        return float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                                       if p.requires_grad}

    counts = (msda.ms_deform_attn_backward.launches, dcn.dcn_im2col.launches,
              dcn.dcn_col2im.launches)
    loss, grads = run()
    per_frame = 2 * 2 + 2
    assert (msda.ms_deform_attn_backward.launches - counts[0],
            dcn.dcn_im2col.launches - counts[1], dcn.dcn_col2im.launches - counts[2]) == (
        per_frame, 2, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "ms_deform_attn", msda.ms_deform_attn_plain)
        mp.setattr(resnet, "dcn_conv", dcn.dcn_conv_plain)
        ref_loss, ref = run()
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    for group in ("img_backbone.", "img_neck.", "pts_bbox_head.transformer.encoder.",
                  "pts_bbox_head.transformer.decoder.", "pts_bbox_head.cls_branches.",
                  "pts_bbox_head.reg_branches."):
        a = torch.cat([g.reshape(-1) for n, g in grads.items() if n.startswith(group)])
        b = torch.cat([g.reshape(-1) for n, g in ref.items() if n.startswith(group)])
        assert float((a - b).norm() / b.norm()) <= 1e-3, group
