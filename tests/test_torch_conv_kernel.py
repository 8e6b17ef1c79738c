"""The dense conv kernel (`csrc/conv_fwd.cu`, `kernels.conv.conv2d_nhwc`)
on the card, against F.conv2d in fp64.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports no jax, so it also runs on a machine without it, from the
repo root:

    python -m pytest --noconftest tests/test_torch_conv_kernel.py -q

Every dense conv shape of bevformer_base and bevformerv2-r50-t8 (exact
Cin, Cout, kernel and stride; `models.conv_sites`) runs at a
reduced size with M = B * OH * OW no multiple of the kernel's 128-pixel
tile, with its site's epilogue. Its error (the largest absolute difference
over the output's largest magnitude, against fp64) must be within 2x that
of cuDNN fp32 with TF32 off on the same inputs, or within 4e-7 where
cuDNN's is smaller than that (a few fp32 roundings of the scale: cuDNN
can be near exact at small K). Then each epilogue variant, the prepared
weight after an in-place update and after `load_state_dict`, and the
model's call sites.
"""

import collections

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.configs import get_config
from bevformer_torch.kernels import conv
from bevformer_torch.models import resnet
from bevformer_torch.models.conv_sites import conv_sites
from bevformer_torch.tools import bench_conv

pytestmark = pytest.mark.cuda

FLOOR = 4e-7  # the error that always passes: a few fp32 roundings of the scale


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


def _shapes():
    """Distinct (Cin, Cout, kernel, stride, norm, ReLU, residual) over the
    two configs' sites, the stem left out (Cin 3: it never engages)."""
    out = collections.OrderedDict()
    for name in ("bevformer_base", "bevformerv2-r50-t8"):
        for site in conv_sites(get_config(name)):
            if not site["engaged"]:
                continue
            key = tuple(site[k] for k in ("cin", "cout", "k", "stride", "norm", "relu",
                                          "residual"))
            out.setdefault(key, f"{name}:{site['name']}")
    return out


SHAPES = _shapes()


def _site(cin, cout, k, stride, norm, relu, residual, b=2, h=11, w=13):
    return dict(name="test", cin=cin, cout=cout, k=k, stride=stride, pad=k // 2, b=b, h=h, w=w,
                oh=conv.out_size(h, k, stride, k // 2), ow=conv.out_size(w, k, stride, k // 2),
                norm=norm, relu=relu, residual=residual)


def _errors(site, device, seed=0):
    """(kernel error, cuDNN fp32 error) of the site against fp64, and the
    kernel's launches."""
    c, norm, x, res = bench_conv.build_site(site, device, seed)
    before = conv.conv2d_nhwc.launches
    with torch.no_grad():
        ref = bench_conv.fp64_reference(c, norm, x, res, site["relu"])
        out = resnet.conv_norm(x, c, norm, site["relu"], res)
        base = bench_conv.fallback(c, norm, x, res, site["relu"])
    torch.cuda.synchronize()
    assert out.shape == base.shape == ref.shape
    return (bench_conv.rel_err(out, ref), bench_conv.rel_err(base, ref),
            conv.conv2d_nhwc.launches - before)


@pytest.mark.parametrize("size", [(11, 13), (67, 69)], ids=["small", "large"])
@pytest.mark.parametrize("key", list(SHAPES), ids=list(SHAPES.values()))
def test_every_dense_conv_shape_against_fp64(cuda_device, key, size):
    """At 2 x 11 x 13 every shape takes 64-column tiles; at 2 x 67 x 69 those
    at stride 1 with Cout a multiple of 128 take 128-column ones."""
    site = _site(*key, h=size[0], w=size[1])
    assert (site["b"] * site["oh"] * site["ow"]) % 128, "M must be ragged"
    err, cudnn_err, launches = _errors(site, cuda_device)
    assert launches == 1
    assert err <= max(2 * cudnn_err, FLOOR), (err, cudnn_err)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("norm", ["frozen", "bn", None])
def test_epilogue_variants(cuda_device, norm, residual, relu):
    """The affine (a FrozenBN's, an eval BatchNorm's, or the conv's bias
    alone), the residual and the ReLU, at both column blocks."""
    for cout, h in ((64, 17), (256, 17), (256, 310)):
        site = _site(64, cout, 3, 1, norm, relu, residual, b=3, h=h, w=9)
        bn = conv.block_n(cout, 3 * h * 9, conv._sms(0))
        assert bn == (128 if h == 310 else 64)
        err, cudnn_err, launches = _errors(site, cuda_device, seed=cout)
        assert launches == 1
        assert err <= max(2 * cudnn_err, FLOOR), (cout, err, cudnn_err)


def test_caffe_stride2_conv1_and_fpn_stride2_extra_conv(cuda_device):
    """A 1x1 stride-2 conv1 (caffe style's stride) and the FPN's 3x3
    stride-2 extra conv, at odd sizes where the last row and column of
    the output read the padding."""
    for site in (_site(256, 128, 1, 2, "frozen", True, False, b=6, h=29, w=50),
                 _site(256, 256, 3, 2, None, False, False, b=6, h=29, w=50),
                 _site(256, 256, 3, 2, None, False, False, b=6, h=15, w=25)):
        err, cudnn_err, _ = _errors(site, cuda_device)
        assert err <= max(2 * cudnn_err, FLOOR), (site, err, cudnn_err)


def _one_conv(device, seed):
    gen = torch.Generator().manual_seed(seed)
    c = nn.Conv2d(64, 128, 3, 1, 1).to(device)
    x = torch.randn(2, 64, 9, 10, generator=gen).to(device).to(memory_format=torch.channels_last)
    return c, x


def test_prepared_weight_follows_the_parameter(cuda_device):
    """The kernel's copy of the weight (and the bias's shift) is made again
    after an in-place update (an optimizer step) and after
    `load_state_dict`, and not otherwise."""
    c, x = _one_conv(cuda_device, 0)

    def check():
        with torch.no_grad():
            out = resnet.conv_norm(x, c)
            ref = F.conv2d(x.double(), c.weight.double(), c.bias.double(), 1, 1)
        assert bench_conv.rel_err(out, ref) < 1e-6

    check()
    bn = conv.block_n(128, 2 * 9 * 10, conv._sms(0))
    prep = conv.prepared_weight(c.weight, bn)
    assert conv.prepared_weight(c.weight, bn) is prep
    with torch.no_grad():
        c.weight.mul_(-2.0)
        c.bias.add_(1.0)
    check()
    assert conv.prepared_weight(c.weight, bn) is not prep
    other, _ = _one_conv(cuda_device, 1)
    c.load_state_dict(other.state_dict())
    check()
    c.weight.data = c.weight.data.clone() * 0.5
    check()


def test_model_sites_engage_on_the_card(cuda_device):
    """A Bottleneck with a downsample at base's stage-2 widths takes the
    kernel at its four convs under no_grad, and the present path while a
    gradient is recorded or under autocast; both give the same output."""
    torch.manual_seed(0)
    block = resnet.Bottleneck(256, 128, 2, True).to(cuda_device).eval()
    x = torch.randn(2, 256, 14, 18, device=cuda_device).to(memory_format=torch.channels_last)
    before = conv.conv2d_nhwc.launches
    with torch.no_grad():
        out = block(x)
    assert conv.conv2d_nhwc.launches - before == 4
    x.requires_grad_(True)
    plain = block(x)
    assert conv.conv2d_nhwc.launches - before == 4
    assert bench_conv.rel_err(out, plain.detach().double()) < 1e-5
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        block(x.detach())
    assert conv.conv2d_nhwc.launches - before == 4
