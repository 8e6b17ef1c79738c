"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no jax (nor does `tests/torch_port_helpers.py`), so it
also runs on a machine without it, from the repo root:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances: msda 1e-5 absolute on N(0, 1) values (same corners, sums in
another order; the pixel position rounds as in the plain version); DCN 1e-5
of the output's scale (fp32 sums of 9*C products in another order).
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
