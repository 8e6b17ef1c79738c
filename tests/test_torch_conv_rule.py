"""Which path each backbone and neck conv takes, on the CPU.

`kernels.conv.engage_rule` is a pure function of what a call can observe;
`models.resnet.rule_inputs` reads its arguments from a call. Over the stem,
the DCN's offset conv, every Bottleneck and FPN conv at the configs'
widths, autocast, a recorded gradient and a BatchNorm in train mode, the
rule (with the device read as "cuda", which this machine has not) chooses
the kernel exactly where the model's design says; on the CPU it never
does, and the modules compute what they computed before (bitwise). The
prepared weight's and the affine's cache (`kernels.conv.cached`) follows
in-place updates, `load_state_dict` and a new storage.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from bevformer_torch.configs import get_config
from bevformer_torch.kernels import conv
from bevformer_torch.models import resnet
from bevformer_torch.models.conv_sites import conv_sites
from bevformer_torch.models.fpn import FPN
from bevformer_torch.models.layers import SyncBatchNorm2d
from bevformer_torch.runtime.fuse import fuse_conv_bn


def on_card(x, c, norm=None, residual=None, **override) -> bool:
    """The rule on this call, as the card would read it."""
    args = dict(resnet.rule_inputs(x, c, norm, residual), device_type="cuda", **override)
    return conv.engage_rule(**args)


def test_rule_cases():
    base = dict(device_type="cuda", dtype=torch.float32, autocast=False, records_grad=False,
                norm_training=False, cin=256, cout=512)
    assert conv.engage_rule(**base)
    for change in (dict(device_type="cpu"), dict(dtype=torch.bfloat16), dict(autocast=True),
                   dict(records_grad=True), dict(norm_training=True), dict(cin=3),
                   dict(cin=48), dict(cout=27), dict(cout=96), dict(plain=False)):
        assert not conv.engage_rule(**dict(base, **change)), change
    assert conv.engage_rule(**dict(base, cin=32, cout=64))


@pytest.mark.parametrize("name", ["bevformer_base", "bevformerv2-r50-t8"])
def test_every_site_but_the_stem_engages(name):
    """Of the configs' dense convs only the stem (Cin 3) keeps cuDNN: 84 of
    base's 85, 60 of t8's 61."""
    sites = conv_sites(get_config(name))
    rule = [conv.engage_rule("cuda", torch.float32, False, False, False, s["cin"], s["cout"])
            for s in sites]
    assert [s["engaged"] for s in sites] == rule
    assert not rule[0] and sites[0]["cin"] == 3 and sites[0]["name"] == "img_backbone.conv1"
    assert all(rule[1:])
    assert len(sites) == {"bevformer_base": 85, "bevformerv2-r50-t8": 61}[name]


@pytest.mark.parametrize("name,engaged", [
    ("bevformer_base", [f"img_backbone.layer1.{i}.conv{j}" for i in range(3) for j in (1, 2, 3)]
     + ["img_backbone.layer1.0.downsample.0"]),
    ("bevformerv2-r50-t8", []),
])
def test_trained_frame_sites(name, engaged):
    """In a training step's trained frame only the frozen stage 1 of v1's
    backbone takes the kernel (no gradient recorded, FrozenBN); V2 freezes
    nothing and its BatchNorms are in train mode; under bf16 autocast no
    site does."""
    sites = conv_sites(get_config(name), train=True)
    assert sorted(s["name"] for s in sites if s["engaged"]) == sorted(engaged)
    bf16 = conv_sites(get_config(name).replace(dtype="bfloat16"))
    assert len(bf16) == len(sites) and not any(s["engaged"] for s in bf16)


def test_int32_offsets_guard():
    """The kernel indexes x and the output in int32: a call with 2^31
    elements in either keeps the present path, and the wrapper refuses it.
    A 1x1 stride-2 conv (caffe style's conv1) reads 4x the output's
    pixels."""
    c = nn.Conv2d(32, 64, 1, stride=2, bias=False)
    big = torch.empty(1, 32, 2**16, 2**10, device="meta")  # 2^31 elements
    assert (1 * 64 * 2**15 * 2**9) < conv.MAX_ELEMENTS
    with torch.no_grad():
        assert not on_card(big, c)
        assert on_card(big[:, :, : 2**15], c)
    weight, ones = (torch.empty(s, device="meta") for s in ((64, 32, 1, 1), (64,)))
    with pytest.raises(ValueError, match="2\\^31"):
        conv._check(big.permute(0, 2, 3, 1).contiguous(), weight, 2, 0, ones, ones, None)
    conv._check(big[:, :, : 2**15].permute(0, 2, 3, 1).contiguous(), weight, 2, 0, ones, ones,
                None)


def _block(norm="frozen", dcn=False):
    torch.manual_seed(0)
    return resnet.Bottleneck(256, 128, 2, True, use_dcn=dcn, norm=norm).eval()


def test_bottleneck_and_fpn_calls():
    x = torch.randn(1, 256, 8, 8)
    block = _block()
    with torch.no_grad():
        mid = torch.randn(1, 128, 4, 4)
        calls = [(x, block.conv1, block.bn1, None), (mid, block.conv2, block.bn2, None),
                 (x, block.downsample[0], block.downsample[1], None),
                 (mid, block.conv3, block.bn3, torch.randn(1, 512, 4, 4))]
        assert all(on_card(*c) for c in calls)
        # the CPU keeps the present path
        assert not any(conv.engage_rule(**resnet.rule_inputs(*c)) for c in calls)
        # autocast, as the bf16 configs run
        assert not on_card(x, block.conv1, block.bn1, autocast=True)
    # a gradient recorded through the input, the weight or the residual
    assert not on_card(x.clone().requires_grad_(), block.conv1, block.bn1)
    block.conv1.weight.requires_grad_(True)
    assert not on_card(x, block.conv1, block.bn1)
    res = torch.randn(1, 512, 4, 4, requires_grad=True)
    assert not on_card(mid, block.conv3, block.bn3, res)
    with torch.no_grad():
        assert on_card(x.clone().requires_grad_(), block.conv1, block.bn1)
    # FrozenBN in train mode stays frozen; a BatchNorm in train mode does not
    block.train()
    with torch.no_grad():
        assert on_card(x, block.conv1, block.bn1)
        bn_block = _block("bn").train()
        assert not on_card(x, bn_block.conv1, bn_block.bn1)
        assert on_card(x, bn_block.conv1, bn_block.bn1.eval())
        assert isinstance(bn_block.bn1, SyncBatchNorm2d)
        # the stem and the DCN's offset conv never
        stem = resnet.ResNet(10).conv1
        assert not on_card(torch.randn(1, 3, 16, 16), stem, resnet.FrozenBN(64))
        dcn = _block(dcn=True).conv2
        assert not on_card(torch.randn(1, 128, 4, 4), dcn.conv_offset)
        # FPN: lateral 1x1, output 3x3, stride-2 extra 3x3 (their bias only)
        fpn = FPN((512, 1024, 2048), 256, 4)
        for m, cin in ((fpn.lateral_convs[1].conv, 1024), (fpn.fpn_convs[0].conv, 256),
                       (fpn.fpn_convs[3].conv, 256)):
            assert on_card(torch.randn(1, cin, 6, 6), m)


def _old_bottleneck(block, x):
    """Bottleneck.forward as it was before the kernel."""
    out = F.relu(block.bn1(block.conv1(x)))
    out = F.relu(block.bn2(block.conv2(out)))
    out = block.bn3(block.conv3(out))
    identity = x if block.downsample is None else block.downsample(x)
    return F.relu(out + identity)


@pytest.mark.parametrize("norm", ["frozen", "bn"])
def test_cpu_path_is_the_present_path(norm):
    block = _block(norm)
    for m in block.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.normal_()
            m.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 256, 9, 7).to(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(block(x), _old_bottleneck(block, x))
    xg = x.clone().requires_grad_()
    block.train()
    new = block(xg)
    old = _old_bottleneck(block, xg)
    assert torch.equal(new, old)
    ga, = torch.autograd.grad(new.sum(), xg)
    gb, = torch.autograd.grad(old.sum(), xg)
    assert torch.equal(ga, gb)


def test_affine_matches_the_norm_and_a_folded_model():
    """(scale, shift) of a FrozenBN, an eval BatchNorm, the identity a
    folded model leaves (with the folded bias) and a biased conv alone."""
    torch.manual_seed(1)
    x = torch.randn(2, 64, 6, 5)
    for norm in (resnet.FrozenBN(128), nn.BatchNorm2d(128).eval(), None):
        c = nn.Conv2d(64, 128, 3, 1, 1, bias=norm is None)
        if norm is not None:
            for name in ("weight", "bias", "running_mean"):
                getattr(norm, name).data.normal_()
            norm.running_var.data.uniform_(0.5, 2.0)
        with torch.no_grad():
            want = c(x) if norm is None else norm(c(x))
            scale, shift = resnet._norm_affine(c, norm)
            got = F.conv2d(x, c.weight, None, 1, 1) * scale[:, None, None] + shift[:, None, None]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    block = _block()
    for m in block.modules():
        if isinstance(m, resnet.FrozenBN):
            m.running_mean.normal_()
    with torch.no_grad():
        want = block(x := torch.randn(1, 256, 8, 8))
        fuse_conv_bn(block)
        assert isinstance(block.bn1, nn.Identity) and block.conv1.bias is not None
        scale, shift = resnet._norm_affine(block.conv1, block.bn1)
        assert torch.equal(scale, torch.ones(128)) and torch.equal(shift, block.conv1.bias)
        torch.testing.assert_close(block(x), want, rtol=1e-5, atol=1e-5)


def test_cache_follows_the_tensors():
    c = nn.Conv2d(64, 128, 1)
    norm = resnet.FrozenBN(128)
    made = []

    def get():
        return conv.cached(c.weight, "affine", resnet._norm_tensors(c, norm),
                           lambda: made.append(1) or resnet._norm_affine(c, norm))

    first = get()
    assert get() is first and len(made) == 1
    with torch.no_grad():
        c.bias.add_(1.0)  # an in-place update bumps the version
    assert get() is not first and len(made) == 2
    norm.load_state_dict({k: v + 1 for k, v in norm.state_dict().items()})
    get()
    assert len(made) == 3
    c.bias.data = c.bias.data.clone()  # a new storage
    get()
    assert len(made) == 4
    assert get() is get() and len(made) == 4
