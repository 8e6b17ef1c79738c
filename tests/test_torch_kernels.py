"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no jax (nor does `tests/torch_port_helpers.py`), so it
also runs on a machine without it, from the repo root:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: msda 1e-5 absolute on N(0, 1) values (same corners, sums in
another order; the pixel position rounds as in the plain version), for K1
and each of its tiles, K7 and each of K7's tiles; the probe modes 1e-5 of
their scale; the row gather bitwise (it copies bytes); DCN 1e-5 of the
output's scale (3xTF32 products keep fp32's accuracy: sums of 9*C products
in another order). The
backward kernels: 1e-5 of each gradient's scale (the same corners; sums over
channels and atomic adds in another order, so dValue and dx are not bitwise
deterministic from run to run).
"""

import numpy as np
import pytest
import torch

from bevformer_torch.kernels import dcn, gather, msda
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


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", MSDA_CASES, ids=[c[0] for c in MSDA_CASES])
def test_msda_ho_kernel_matches_plain(cuda_device, name, b, q, h, d, shapes, p):
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 20 + len(name), cuda_device)
    before = msda.ms_deform_attn_ho.launches
    out = msda.ms_deform_attn_ho(value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn_ho.launches == before + 1
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    assert float((out - ref).abs().max()) <= 1e-5, name


@pytest.mark.parametrize("tile", msda.HO_TILES)
@pytest.mark.parametrize("acc", msda.HO_ACCS)
def test_msda_ho_tiles_match_plain(cuda_device, tile, acc):
    """Every instantiation of the sweep, with a query count no tile divides."""
    name, b, q, h, d, shapes, p = MSDA_CASES[1]
    value, loc, attw = _msda_inputs(b, q + 3, h, d, shapes, p, tile + acc, cuda_device)
    out = msda.msda_probe("ho", "full", value, shapes, loc, attw, tile=tile, acc=acc)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    assert float((out - ref).abs().max()) <= 1e-5


# K1 at the inference path's shapes with Q cut (the value maps at full
# size), a ragged Q, and D = 64
K1_PATH_CASES = [
    ("tsa", 2, 1000, 8, 32, ((200, 200),), 4),
    ("sca", 6, 300, 8, 32, ((116, 200), (58, 100), (29, 50), (15, 25)), 8),
    ("decoder", 1, 900, 8, 32, ((200, 200),), 4),
    ("ragged_q", 2, 131, 8, 32, ((30, 40), (15, 20)), 4),
    ("d64", 2, 77, 4, 64, ((20, 30), (10, 15), (5, 8)), 8),
]


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", K1_PATH_CASES,
                         ids=[c[0] for c in K1_PATH_CASES])
def test_msda_kernel_at_the_path_shapes(cuda_device, name, b, q, h, d, shapes, p):
    """Locations uniform on [-0.2, 1.2] with no order (fully incoherent)."""
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 40 + len(name), cuda_device)
    out = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    assert float((out - ref).abs().max()) <= 1e-5, name


@pytest.mark.parametrize("tile", msda.K1_TILES)
@pytest.mark.parametrize("case", [0, 1, 4], ids=["tsa", "sca", "d64"])
def test_msda_kernel_every_tile(cuda_device, tile, case):
    """K1 at each tile the C entry takes (and so each share of a query's
    samples among a warp's 8-lane groups), with a Q no tile divides."""
    name, b, q, h, d, shapes, p = K1_PATH_CASES[case]
    value, loc, attw = _msda_inputs(b, min(q, 137), h, d, shapes, p, tile, cuda_device)
    out = msda._launch("msda_fwd", value, shapes, loc, attw, tile)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    assert float((out - ref).abs().max()) <= 1e-5, (name, tile)


def test_msda_kernel_refuses_what_its_c_entry_does_not_take(cuda_device):
    value, loc, attw = _msda_inputs(1, 5, 8, 32, ((4, 5),), 2, 0, cuda_device)
    for tile in (0, 3, 256):
        with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
            msda._launch("msda_fwd", value, ((4, 5),), loc, attw, tile)
    # a value tensor off a 16-byte boundary (the kernel's float4 loads)
    shifted = torch.empty(value.numel() + 1, device=cuda_device)[1:].view_as(value)
    shifted.copy_(value)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        msda.ms_deform_attn(shifted, ((4, 5),), loc, attw)


@pytest.mark.parametrize("mode,tile,acc", [("full", 12, 1), ("full", 16, 3), ("gather", 32, 1)])
def test_msda_ho_refuses_an_instantiation_it_lacks(cuda_device, mode, tile, acc):
    name, b, q, h, d, shapes, p = MSDA_CASES[1]
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 31, cuda_device)
    before = msda.msda_probe.launches
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        msda.msda_probe("ho", mode, value, shapes, loc, attw, tile=tile, acc=acc)
    assert msda.msda_probe.launches == before


@pytest.mark.parametrize("kernel,mode", [(k, m) for k in ("hi", "ho")
                                         for m in msda.PROBE_MODES[1:]])
def test_msda_probe_modes_match_plain(cuda_device, kernel, mode):
    name, b, q, h, d, shapes, p = MSDA_CASES[1]
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 30, cuda_device)
    before = msda.msda_probe.launches
    out = msda.msda_probe(kernel, mode, value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert msda.msda_probe.launches == before + 1
    assert_close(out, msda.msda_probe_plain(mode, value, shapes, loc, attw), 1e-5,
                 f"{kernel} {mode}")


@pytest.mark.parametrize("mode", msda.PROBE_MODES[1:])
def test_msda_probe_modes_of_k1_at_tsa_shape(cuda_device, mode):
    """K1's modes where each 8-lane group takes whole queries (4 samples)."""
    name, b, q, h, d, shapes, p = K1_PATH_CASES[0]
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 50, cuda_device)
    out = msda.msda_probe("hi", mode, value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert_close(out, msda.msda_probe_plain(mode, value, shapes, loc, attw), 1e-5, mode)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_gather_kernel_matches_take_along_dim_bitwise(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    src = torch.randn((3, 1000, 256), generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(0, 1000, (3, 700), generator=g, device=cuda_device, dtype=torch.int32)
    before = gather.row_gather.launches
    out = gather.row_gather(src, idx)
    torch.cuda.synchronize()
    assert gather.row_gather.launches == before + 1
    assert torch.equal(out, torch.take_along_dim(src, idx[..., None].long(), 1))


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


DCN_CASES = [
    # name, B, H, W, C, Cout, stride: M = B*OH*OW is no multiple of the
    # block's 64 pixels in any of them
    ("c512_cout512_s2", 1, 11, 13, 512, 512, 2),
    ("c512_cout96", 2, 7, 9, 512, 96, 1),
    ("cout300", 2, 9, 10, 64, 300, 1),
    ("cout50", 1, 8, 11, 32, 50, 2),  # Cout % 8 != 0: a ragged core matrix of the weight
    ("stage4_rows", 1, 29, 50, 512, 512, 1),
]


@pytest.mark.parametrize("name,b,h,w,c,cout,stride", DCN_CASES, ids=[x[0] for x in DCN_CASES])
def test_dcn_kernel_ragged_shapes(cuda_device, name, b, h, w, c, cout, stride):
    args = _dcn_inputs(11, cuda_device, b=b, h=h, w=w, c=c, cout=cout, stride=stride)
    out = dcn.dcn_conv(*args, stride)
    torch.cuda.synchronize()
    assert_close(out, dcn.dcn_conv_plain(*args, stride), 1e-5, name)


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
    with pytest.raises(ValueError):
        msda.ms_deform_attn_ho(value, ((4, 5),), strided, attw)
    src = torch.zeros((2, 8, 3), device=cuda_device)
    with pytest.raises(ValueError):  # 12-byte rows
        gather.row_gather(src, torch.zeros((2, 4), dtype=torch.int32, device=cuda_device))


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
