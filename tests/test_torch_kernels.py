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
deterministic from run to run), K6 also at exact pixel edges and with
samples far off their pixel; K5's column bitwise at the
shapes of its own test (the plain version's operations, unfused). bf16 K1
and K3/K4 (a bf16 value and grad_out, fp32 sums): the bf16 output and dValue
within one bf16 ulp at their scale (the fp32 sums agree but for their
order, then each side rounds once), dLoc and dAttw 1e-3 of their scale.
bf16 K2, K5 and K6 (a bf16 x, fp32 offsets, mask, weight and column
gradient): K2's output and K6's dx within one bf16 ulp at their scale, K5's
column bitwise, K6's d offsets and dmask 1e-5, and the whole bf16 DCN
gradient against autograd through the plain conv (dx one ulp, the fp32
gradients 1e-4: the column gradient's fp32 products in another order).
"""

import numpy as np
import pytest
import torch

from bevformer_torch.kernels import dcn, gather, msda
# by module name, not as `tests.torch_port_helpers`: pytest puts this
# directory on sys.path, and another installed `tests` package would shadow
# the repo's on a machine that has one
from torch_port_helpers import assert_close, bf16_ulps, edge_locations, edge_offsets, t

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


# K1 at a BEVFormerV2 sample's shapes, whole: TSA over the (query, query)
# queue, SCA over the 4 levels of a 640 x 1600 input at capacity 0.25, the
# decoder
K1_V2_CASES = [
    ("v2_tsa", 2, 40000, 8, 32, ((200, 200),), 4),
    ("v2_sca", 6, 10112, 8, 32, ((80, 200), (40, 100), (20, 50), (10, 25)), 8),
    ("v2_decoder", 1, 900, 8, 32, ((200, 200),), 4),
]


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", K1_V2_CASES, ids=[c[0] for c in K1_V2_CASES])
def test_msda_kernel_at_the_v2_shapes(cuda_device, name, b, q, h, d, shapes, p):
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 60 + len(name), cuda_device)
    before = msda.ms_deform_attn.launches
    out = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn.launches == before + 1
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    assert float((out - ref).abs().max()) <= 1e-5, name


# K1 and K3/K4 at BEVFormerV2 training's new shapes, whole: the decoder
# over 900 x 11 GroupDETR queries, SCA over the 4 levels of the 768 rung's
# 768 x 1920 input at capacity 0.25
K1_V2_TRAIN_CASES = [
    ("v2_decoder_groups", 1, 9900, 8, 32, ((200, 200),), 4),
    ("v2_sca_768", 6, 10112, 8, 32, ((96, 240), (48, 120), (24, 60), (12, 30)), 8),
]


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", K1_V2_TRAIN_CASES,
                         ids=[c[0] for c in K1_V2_TRAIN_CASES])
def test_msda_kernels_at_the_v2_training_shapes(cuda_device, name, b, q, h, d, shapes, p):
    """K1 to 1e-5 max abs, K3/K4 to 1e-5 of each gradient's scale, each
    launched once."""
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 80 + len(name), cuda_device)
    fwd, bwd = msda.ms_deform_attn.launches, msda.ms_deform_attn_backward.launches
    out = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    assert float((out - ref).abs().max()) <= 1e-5, name
    del out, ref
    g = torch.randn((b, q, h * d), device=cuda_device)
    grads = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    assert msda.ms_deform_attn.launches == fwd + 1
    assert msda.ms_deform_attn_backward.launches == bwd + 1
    _check_backward(grads, value, shapes, loc, attw, g, name)


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


def _check_backward(grads, value, shapes, loc, attw, g, name):
    """The kernel's (dValue, dLoc, dAttw) against autograd through the plain
    msda, 1e-5 of each gradient's scale."""
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g)
    for what, a, r in zip(("dvalue", "dloc", "dattw"), grads, ref):
        assert_close(a, r, 1e-5, f"{name} {what}")


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", MSDA_CASES, ids=[c[0] for c in MSDA_CASES])
def test_msda_backward_kernel_matches_plain(cuda_device, name, b, q, h, d, shapes, p):
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 7 + len(name), cuda_device)
    g = torch.randn((b, q, h * d), device=cuda_device)
    before = msda.ms_deform_attn_backward.launches
    grads = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    assert msda.ms_deform_attn_backward.launches == before + 1
    _check_backward(grads, value, shapes, loc, attw, g, name)


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", K1_PATH_CASES,
                         ids=[c[0] for c in K1_PATH_CASES])
def test_msda_backward_kernel_at_the_path_shapes(cuda_device, name, b, q, h, d, shapes, p):
    """K3/K4 at the training path's three shapes with Q cut (the value maps
    at full size), a ragged Q and D = 64; locations incoherent."""
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 60 + len(name), cuda_device)
    g = torch.randn((b, q, h * d), device=cuda_device)
    grads = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    _check_backward(grads, value, shapes, loc, attw, g, name)


@pytest.mark.parametrize("tile", msda.K1_TILES)
@pytest.mark.parametrize("case", [0, 1, 4], ids=["tsa", "sca", "d64"])
def test_msda_backward_kernel_every_tile(cuda_device, tile, case):
    """K3/K4 at each tile the C entry takes (and so each share of a query's
    samples among a warp's 8-lane groups), with a Q no tile divides."""
    name, b, q, h, d, shapes, p = K1_PATH_CASES[case]
    q = min(q, 137)
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 70 + tile, cuda_device)
    g = torch.randn((b, q, h * d), device=cuda_device)
    grads = msda._launch_bwd(value, shapes, loc, attw, g, tile)
    _check_backward(grads, value, shapes, loc, attw, g, f"{name} tile {tile}")


EDGE_CASES = [
    # name, B, Q, H, D, spatial shapes (powers of two), P
    ("one_level", 2, 50, 8, 32, ((16, 32),), 4),
    ("four_levels", 2, 37, 8, 32, ((16, 32), (8, 16), (4, 8), (2, 4)), 8),
    ("d64", 1, 29, 4, 64, ((8, 16), (4, 8)), 4),
]


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_msda_backward_kernel_at_exact_pixel_edges(cuda_device, name, b, q, h, d, shapes, p):
    """Pixel positions exactly on cell edges (x or y = -1, 0, integers,
    size - 1) and off the map: the kernel's bounds test (-1 <= x < w, -1 <=
    y < h) and pixel rounding give the plain version's gradients, including
    the nonzero dLoc.x of a sample at x == -1."""
    value, _, attw = _msda_inputs(b, q, h, d, shapes, p, 80 + len(name), cuda_device)
    loc = t(edge_locations(np.random.RandomState(len(name)), b, q, h, shapes, p)).to(cuda_device)
    g = torch.randn((b, q, h * d), device=cuda_device)
    grads = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    _check_backward(grads, value, shapes, loc, attw, g, name)


def test_msda_backward_kernel_samples_off_the_map(cuda_device):
    """Queries whose every sample lies off the map on some side: their dLoc
    and dAttw are exactly 0 (and dValue, held to the plain version, gets
    nothing from them)."""
    name, b, q, h, d, shapes, p = K1_PATH_CASES[1]
    q = 64
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, 90, cuda_device)
    off = loc.clone()
    hw = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=torch.float32, device=cuda_device)
    # pixel positions below -1 (x and y), or half a pixel past the map's
    # width or height, a query each
    off[:, 0::4] = -1.5 / hw[:, None, :] - loc[:, 0::4].abs()
    off[:, 1::4, ..., 0] = 1 + 1 / hw[:, None, 0] + loc[:, 1::4, ..., 0].abs()
    off[:, 2::4, ..., 1] = 1 + 1 / hw[:, None, 1]
    g = torch.randn((b, q, h * d), device=cuda_device)
    grads = msda.ms_deform_attn_backward(value, shapes, off, attw, g)
    _check_backward(grads, value, shapes, off, attw, g, "off the map")
    for qs in (slice(0, None, 4), slice(1, None, 4), slice(2, None, 4)):
        assert not grads[1][:, qs].any() and not grads[2][:, qs].any()


def test_msda_backward_kernel_refuses_what_its_c_entry_does_not_take(cuda_device):
    value, loc, attw = _msda_inputs(1, 5, 8, 32, ((4, 5),), 2, 0, cuda_device)
    g = torch.randn((1, 5, 256), device=cuda_device)
    for tile in (0, 3, 256):
        with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
            msda._launch_bwd(value, ((4, 5),), loc, attw, g, tile)
    # value or grad_out off a 16-byte boundary (the float4 loads)
    before = msda.ms_deform_attn_backward.launches
    for which in (0, 1):
        args = [value, g]
        shifted = torch.empty(args[which].numel() + 1, device=cuda_device)[1:]
        args[which] = shifted.view_as(args[which]).copy_(args[which])
        with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
            msda.ms_deform_attn_backward(args[0], ((4, 5),), loc, attw, args[1])
    assert msda.ms_deform_attn_backward.launches == before


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


IM2COL_CASES = [
    # name, B, H, W, C, stride: B*OH*OW no multiple of the block's pixels
    ("ragged", 1, 7, 9, 64, 1),
    ("stride2", 2, 11, 13, 256, 2),
    ("c32", 3, 13, 21, 32, 1),
    ("c512", 1, 9, 11, 512, 1),
]


@pytest.mark.parametrize("name,b,h,w,c,stride", IM2COL_CASES, ids=[x[0] for x in IM2COL_CASES])
def test_dcn_im2col_kernel_shapes(cuda_device, name, b, h, w, c, stride):
    """K5 does the plain version's arithmetic operation for operation, with
    no FMA, so its column is the plain one's bitwise."""
    x, off_y, off_x, mask, _ = _dcn_inputs(12, cuda_device, b=b, h=h, w=w, c=c, cout=32,
                                           stride=stride)
    cols = dcn.dcn_im2col(x, off_y, off_x, mask, stride)
    torch.cuda.synchronize()
    assert torch.equal(cols, dcn.dcn_im2col_plain(x, off_y, off_x, mask, stride)), name


def test_dcn_im2col_kernel_refuses_what_its_c_entry_does_not_take(cuda_device):
    before = dcn.dcn_im2col.launches
    x, off_y, off_x, mask, _ = _dcn_inputs(0, cuda_device, c=6, cout=8)  # C % 4 != 0
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        dcn.dcn_im2col(x, off_y, off_x, mask)
    x, off_y, off_x, mask, _ = _dcn_inputs(0, cuda_device, c=32, cout=8)
    # x off a 16-byte boundary (the float4 loads)
    shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x).copy_(x)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        dcn.dcn_im2col(shifted, off_y, off_x, mask)
    assert dcn.dcn_im2col.launches == before


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


COL2IM_CASES = [
    # name, B, H, W, C, stride, offsets: "edge" (samples exactly on cell
    # edges, powers-of-two maps), "far" (uniform on +-20 px), or a std in px
    ("edge_c256", 2, 16, 32, 256, 1, "edge"),
    ("edge_c512", 1, 8, 16, 512, 1, "edge"),
    ("edge_c256_stride2", 2, 16, 32, 256, 2, "edge"),
    ("far_c256", 1, 48, 64, 256, 1, "far"),
    ("far_c512", 1, 32, 48, 512, 1, "far"),
    # the mapping's edges: B 1 and B*OH*OW no multiple of the block's 8
    # pixels, C 32 (one float4 per lane), C 36 and 4 (lanes idle), one row
    # of output pixels, one column
    ("ragged_b1", 1, 13, 21, 64, 1, 1.0),
    ("c32_one_pass", 3, 9, 17, 32, 1, 1.0),
    ("c36_partial_pass", 2, 10, 11, 36, 1, 1.0),
    ("c4", 2, 7, 9, 4, 1, 1.0),
    ("one_row", 1, 1, 40, 64, 1, 1.0),
    ("one_column", 1, 12, 1, 64, 1, 1.0),
]


def _col2im_inputs(seed, device, b, h, w, c, stride, offsets):
    rng = np.random.RandomState(seed)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, c).astype(np.float32)
    if offsets == "edge":
        off_y, off_x = edge_offsets(rng, b, oh, ow, h), edge_offsets(rng, b, oh, ow, w)
    elif offsets == "far":
        off_y, off_x = (rng.uniform(-20, 20, (2, b, oh, ow, 9)).astype(np.float32))
    else:
        off_y, off_x = (rng.randn(2, b, oh, ow, 9) * offsets).astype(np.float32)
    mask = rng.rand(b, oh, ow, 9).astype(np.float32)
    dcols = rng.randn(b * oh * ow, 9 * c).astype(np.float32)
    return [t(a).to(device) for a in (x, off_y, off_x, mask, dcols)]


@pytest.mark.parametrize("name,b,h,w,c,stride,offsets", COL2IM_CASES,
                         ids=[x[0] for x in COL2IM_CASES])
def test_dcn_col2im_kernel_cases(cuda_device, name, b, h, w, c, stride, offsets):
    """K6 against the plain version at exact pixel edges (its bounds test
    -1 <= py < H keeps the slope of a sample at py == -1), with samples far
    off their pixel, and at the edges of its mapping, at both stage widths
    (C 256 and 512)."""
    args = _col2im_inputs(len(name), cuda_device, b, h, w, c, stride, offsets)
    grads = dcn.dcn_col2im(*args, stride)
    torch.cuda.synchronize()
    ref = dcn.dcn_col2im_plain(*args, stride)
    for what, a, r in zip(("dx", "doff_y", "doff_x", "dmask"), grads, ref):
        assert_close(a, r, 1e-5, f"{name} {what}")


def test_dcn_col2im_kernel_refuses_what_its_c_entry_does_not_take(cuda_device):
    """The C entry refuses C % 4, x, dcols or dx off a 16-byte boundary (the
    float4 loads and atomics) and a stride below 1 (which the wrapper's
    shape checks never pass: it is called directly)."""
    from bevformer_torch.kernels import build

    before = dcn.dcn_col2im.launches
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        dcn.dcn_col2im(*_col2im_inputs(0, cuda_device, 1, 5, 7, 6, 1, 1.0))
    args = _col2im_inputs(0, cuda_device, 1, 5, 7, 32, 1, 1.0)
    for which in (0, 4):  # x, dcols
        shifted = list(args)
        shifted[which] = torch.empty(args[which].numel() + 1, device=cuda_device)[1:].view_as(
            args[which]).copy_(args[which])
        with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
            dcn.dcn_col2im(*shifted)
    assert dcn.dcn_col2im.launches == before
    x, off_y, off_x, mask, dcols = args
    outs = [torch.zeros_like(x), *(torch.empty_like(off_y) for _ in range(3))]
    rc = build.library().dcn_col2im(
        x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(), dcols.data_ptr(),
        *(t.data_ptr() for t in outs), 1, 5, 7, 32, 5, 7, 0,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        build.check_launch("dcn_col2im", rc)
    dx = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x)  # dx off 16 bytes
    rc = build.library().dcn_col2im(
        x.data_ptr(), off_y.data_ptr(), off_x.data_ptr(), mask.data_ptr(), dcols.data_ptr(),
        dx.data_ptr(), *(t.data_ptr() for t in outs[1:]), 1, 5, 7, 32, 5, 7, 1,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        build.check_launch("dcn_col2im", rc)


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


# ---------------------------------------------------------------- bf16 K1, K3/K4

BF16_CASES = [
    # bevformer_tiny_fp16's three shapes (TSA, dense SCA, decoder) and
    # bevformer_base's three in bf16 (SCA's Q cut)
    ("tiny_tsa", 2, 2500, 8, 32, ((50, 50),), 4),
    ("tiny_sca", 6, 2500, 8, 32, ((15, 25),), 8),
    ("tiny_decoder", 1, 900, 8, 32, ((50, 50),), 4),
    ("base_sca", 6, 300, 8, 32, ((116, 200), (58, 100), (29, 50), (15, 25)), 8),
    ("base_tsa", 2, 40000, 8, 32, ((200, 200),), 4),
    ("base_decoder", 1, 900, 8, 32, ((200, 200),), 4),
]


def _bf16_inputs(b, q, h, d, shapes, p, seed, device):
    value, loc, attw = _msda_inputs(b, q, h, d, shapes, p, seed, device)
    return value.bfloat16(), loc, attw


def _within_a_bf16_ulp(ours, ref, name):
    """max |ours - ref| <= one bf16 ulp at max |ref|."""
    assert ours.dtype == ref.dtype == torch.bfloat16, (name, ours.dtype, ref.dtype)
    err = bf16_ulps(ours, ref)
    assert err <= 1, f"{name}: {err:.2f} bf16 ulps at max |ref|"


def _check_bf16_backward(grads, value, shapes, loc, attw, g, name):
    torch.cuda.synchronize()
    ref = msda.ms_deform_attn_backward_plain(value, shapes, loc, attw, g)
    _within_a_bf16_ulp(grads[0], ref[0], f"{name} dvalue")
    for what, a, r in zip(("dloc", "dattw"), grads[1:], ref[1:]):
        assert a.dtype == torch.float32
        assert_close(a, r, 1e-3, f"{name} {what}")


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_msda_kernel_matches_plain(cuda_device, name, b, q, h, d, shapes, p):
    value, loc, attw = _bf16_inputs(b, q, h, d, shapes, p, 100 + len(name), cuda_device)
    before = msda.MSDA_FWD_BF16.launches, msda.ms_deform_attn.launches
    out = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert (msda.MSDA_FWD_BF16.launches, msda.ms_deform_attn.launches) == (
        before[0] + 1, before[1])
    _within_a_bf16_ulp(out, msda.ms_deform_attn_plain(value, shapes, loc, attw), name)


@pytest.mark.parametrize("tile", msda.K1_TILES)
@pytest.mark.parametrize("case", [0, 1, 3], ids=["tsa", "sca", "base_sca"])
def test_bf16_msda_kernel_every_tile(cuda_device, tile, case):
    name, b, q, h, d, shapes, p = BF16_CASES[case]
    value, loc, attw = _bf16_inputs(b, 137, h, d, shapes, p, tile, cuda_device)
    out = msda._launch("msda_fwd_bf16", value, shapes, loc, attw, tile)
    torch.cuda.synchronize()
    _within_a_bf16_ulp(out, msda.ms_deform_attn_plain(value, shapes, loc, attw),
                       f"{name} tile {tile}")


@pytest.mark.parametrize("name,b,q,h,d,shapes,p", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_bf16_msda_backward_kernel_matches_plain(cuda_device, name, b, q, h, d, shapes, p):
    value, loc, attw = _bf16_inputs(b, q, h, d, shapes, p, 110 + len(name), cuda_device)
    g = torch.randn((b, q, h * d), device=cuda_device).bfloat16()
    before = msda.MSDA_BWD_BF16.launches, msda.ms_deform_attn_backward.launches
    grads = msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    assert (msda.MSDA_BWD_BF16.launches, msda.ms_deform_attn_backward.launches) == (
        before[0] + 1, before[1])
    _check_bf16_backward(grads, value, shapes, loc, attw, g, name)


@pytest.mark.parametrize("tile", msda.K1_TILES)
@pytest.mark.parametrize("case", [0, 1, 3], ids=["tsa", "sca", "base_sca"])
def test_bf16_msda_backward_kernel_every_tile(cuda_device, tile, case):
    name, b, q, h, d, shapes, p = BF16_CASES[case]
    value, loc, attw = _bf16_inputs(b, 137, h, d, shapes, p, 120 + tile, cuda_device)
    g = torch.randn((b, 137, h * d), device=cuda_device).bfloat16()
    grads = msda._launch_bwd(value, shapes, loc, attw, g, tile)
    _check_bf16_backward(grads, value, shapes, loc, attw, g, f"{name} tile {tile}")


def test_bf16_msda_autograd_runs_the_bf16_kernels(cuda_device):
    """A bf16 value through `ms_deform_attn` and autograd: the bf16 forward
    and backward entries launch once each, no fp32 one does, and the
    gradients have the inputs' dtypes."""
    value, loc, attw = _bf16_inputs(2, 40, 8, 32, ((6, 9), (3, 5)), 4, 2, cuda_device)
    leaves = [x.clone().requires_grad_() for x in (value, loc, attw)]
    counters = (msda.MSDA_FWD_BF16, msda.MSDA_BWD_BF16, msda.ms_deform_attn,
                msda.ms_deform_attn_backward)
    before = [c.launches for c in counters]
    out = msda.ms_deform_attn(leaves[0], ((6, 9), (3, 5)), leaves[1], leaves[2])
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 0, 0]
    assert [x.grad.dtype for x in leaves] == [torch.bfloat16, torch.float32, torch.float32]


def test_bf16_msda_refuses_mixed_dtypes(cuda_device):
    """K1 and K3/K4 take a bf16 or fp32 value with fp32 locations and
    weights, and a grad_out of the value's dtype; K7 and the probes an fp32
    value only. Anything else raises before a launch: nothing upcasts a bf16
    value to run the fp32 kernel."""
    value, loc, attw = _bf16_inputs(1, 5, 8, 32, ((4, 5),), 2, 0, cuda_device)
    shapes = ((4, 5),)
    g = torch.randn((1, 5, 256), device=cuda_device)
    launches = [c.launches for c in (msda.MSDA_FWD_BF16, msda.MSDA_BWD_BF16, msda.ms_deform_attn,
                                     msda.ms_deform_attn_backward, msda.ms_deform_attn_ho)]
    for bad in ((value, loc.bfloat16(), attw), (value, loc, attw.bfloat16()),
                (value.half(), loc, attw), (value.float(), loc, attw.bfloat16())):
        with pytest.raises(TypeError):
            msda.ms_deform_attn(bad[0], shapes, bad[1], bad[2])
    with pytest.raises(TypeError):  # an fp32 grad_out for a bf16 value
        msda.ms_deform_attn_backward(value, shapes, loc, attw, g)
    with pytest.raises(TypeError):  # a bf16 grad_out for an fp32 value
        msda.ms_deform_attn_backward(value.float(), shapes, loc, attw, g.bfloat16())
    with pytest.raises(TypeError):
        msda.ms_deform_attn_ho(value, shapes, loc, attw)
    with pytest.raises(TypeError):
        msda.msda_probe("hi", "gather", value, shapes, loc, attw)
    assert launches == [c.launches for c in (msda.MSDA_FWD_BF16, msda.MSDA_BWD_BF16,
                                              msda.ms_deform_attn, msda.ms_deform_attn_backward,
                                              msda.ms_deform_attn_ho)]


@pytest.mark.parametrize("offset", [1, 4])
def test_bf16_msda_refuses_misaligned_tensors(cuda_device, offset):
    """A bf16 value or grad_out off a 16-byte boundary (2 and 8 bytes off)
    is refused by the C entries, as an fp32 one is."""
    value, loc, attw = _bf16_inputs(1, 5, 8, 32, ((4, 5),), 2, 0, cuda_device)
    g = torch.randn((1, 5, 256), device=cuda_device).bfloat16()

    def shifted(x):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)[offset:]
        return buf.view_as(x).copy_(x)

    before = msda.MSDA_FWD_BF16.launches, msda.MSDA_BWD_BF16.launches
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        msda.ms_deform_attn(shifted(value), ((4, 5),), loc, attw)
    for args in ((shifted(value), g), (value, shifted(g))):
        with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
            msda.ms_deform_attn_backward(args[0], ((4, 5),), loc, attw, args[1])
    assert (msda.MSDA_FWD_BF16.launches, msda.MSDA_BWD_BF16.launches) == before


# ---------------------------------------------------------------- bf16 DCN

def _bf16_dcn_inputs(seed, device, b=3, h=13, w=21, c=64, cout=96, stride=1):
    """_dcn_inputs with a bf16 x (the weight stays fp32)."""
    x, off_y, off_x, mask, weight = _dcn_inputs(seed, device, b, h, w, c, cout, stride)
    return [x.bfloat16(), off_y, off_x, mask, weight]


BF16_DCN_CASES = [("small", 3, 13, 21, 64, 96, 1), ("stride2", 2, 11, 13, 64, 96, 2)] + [
    c for c in DCN_CASES if c[0] != "c512_cout512_s2"]


@pytest.mark.parametrize("name,b,h,w,c,cout,stride", BF16_DCN_CASES,
                         ids=[x[0] for x in BF16_DCN_CASES])
def test_bf16_dcn_kernel_matches_plain(cuda_device, name, b, h, w, c, cout, stride):
    """bf16 K2 (dcn_conv_fwd_bf16): a bf16 output within one bf16 ulp at
    its scale of the plain version's (the same bf16 column and weight, fp32
    sums in another order, each side rounding once), ragged M and Cout
    included; it counts on DCN_CONV_FWD_BF16, not on the fp32 wrapper."""
    args = _bf16_dcn_inputs(13 + len(name), cuda_device, b, h, w, c, cout, stride)
    before = dcn.DCN_CONV_FWD_BF16.launches, dcn.dcn_conv.launches
    out = dcn.dcn_conv(*args, stride)
    torch.cuda.synchronize()
    assert (dcn.DCN_CONV_FWD_BF16.launches, dcn.dcn_conv.launches) == (before[0] + 1, before[1])
    assert out.dtype == torch.bfloat16
    _within_a_bf16_ulp(out, dcn.dcn_conv_plain(*args, stride), name)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_dcn_im2col_kernel_matches_plain(cuda_device, stride):
    """bf16 K5 (dcn_im2col_bf16): the bf16 column bitwise (the plain
    version's fp32 operations, unfused, rounded once)."""
    x, off_y, off_x, mask, _ = _bf16_dcn_inputs(5, cuda_device, stride=stride)
    before = dcn.DCN_IM2COL_BF16.launches
    cols = dcn.dcn_im2col(x, off_y, off_x, mask, stride)
    torch.cuda.synchronize()
    assert dcn.DCN_IM2COL_BF16.launches == before + 1 and cols.dtype == torch.bfloat16
    assert torch.equal(cols, dcn.dcn_im2col_plain(x, off_y, off_x, mask, stride))


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_dcn_col2im_kernel_matches_plain(cuda_device, stride):
    """bf16 K6 (dcn_col2im_gw) on a bf16 output gradient and the weight:
    dx bf16 within one bf16 ulp at its scale (fp32 atomic sums, rounded
    once), d offsets and dmask fp32 to 1e-5 of their scale (the column
    gradient summed by the tensor cores, truncating, drifts ~1e-6 of scale
    from the plain version's fp32 product); ragged M (a last 64-pixel tile
    part empty), C 64 (a 256-channel part mostly empty) and Cout 96 (a K
    tile of 32)."""
    x, off_y, off_x, mask, weight = _bf16_dcn_inputs(6, cuda_device, stride=stride)
    g = torch.randn((off_y.shape[0] * off_y.shape[1] * off_y.shape[2], weight.shape[1]),
                    device=cuda_device).bfloat16()
    before = dcn.DCN_COL2IM_BF16.launches
    grads = dcn.dcn_col2im_gw(x, off_y, off_x, mask, g, weight, stride)
    torch.cuda.synchronize()
    assert dcn.DCN_COL2IM_BF16.launches == before + 1
    ref = dcn.dcn_col2im_gw_plain(x, off_y, off_x, mask, g, weight, stride)
    assert grads[0].dtype == torch.bfloat16
    _within_a_bf16_ulp(grads[0], ref[0], f"stride {stride} dx")
    for what, a, r in zip(("doff_y", "doff_x", "dmask"), grads[1:], ref[1:]):
        assert a.dtype == torch.float32
        assert_close(a, r, 1e-5, f"stride {stride} {what}")


BF16_K6_CASES = [
    # name, B, H, W, C, Cout, stride
    ("c512_cout512_s2", 1, 11, 13, 512, 512, 2),  # two 256-channel parts a tap
    ("stage4_rows", 1, 29, 50, 512, 512, 1),
    ("c96_cout48", 2, 9, 10, 96, 48, 1),  # a K tile of 48, a part of 96 channels
    ("c32_cout16", 1, 8, 11, 32, 16, 2),  # one 16-deep K tile
    ("c288_cout80", 1, 7, 9, 288, 80, 1),  # a second part of 32 channels, K tiles 64 + 16
]


@pytest.mark.parametrize("name,b,h,w,c,cout,stride", BF16_K6_CASES,
                         ids=[x[0] for x in BF16_K6_CASES])
def test_bf16_dcn_col2im_gw_cases(cuda_device, name, b, h, w, c, cout, stride):
    """bf16 K6 (dcn_col2im_gw) where its parts, K tiles or last tile could
    go wrong, against its plain version: dx within one bf16 ulp, d offsets
    and dmask to 1e-5 of their scale, and d offsets and dmask bitwise the
    same in a second launch (their sums run in a fixed order)."""
    x, off_y, off_x, mask, weight = _bf16_dcn_inputs(17 + len(name), cuda_device, b, h, w, c,
                                                     cout, stride)
    g = torch.randn((off_y.shape[0] * off_y.shape[1] * off_y.shape[2], cout),
                    device=cuda_device).bfloat16()
    grads = dcn.dcn_col2im_gw(x, off_y, off_x, mask, g, weight, stride)
    again = dcn.dcn_col2im_gw(x, off_y, off_x, mask, g, weight, stride)
    ref = dcn.dcn_col2im_gw_plain(x, off_y, off_x, mask, g, weight, stride)
    torch.cuda.synchronize()
    _within_a_bf16_ulp(grads[0], ref[0], f"{name} dx")
    for what, a, a2, r in zip(("doff_y", "doff_x", "dmask"), grads[1:], again[1:], ref[1:]):
        assert_close(a, r, 1e-5, f"{name} {what}")
        assert torch.equal(a, a2), f"{name} {what}: not deterministic"


def test_bf16_dcn_gradient_matches_autograd_through_plain(cuda_device):
    """The bf16 `_DCNConv` (K2, then K5, the fp32 dWeight product and K6
    from the output gradient) against autograd through the plain bf16 conv,
    inside bf16 autocast (the backward's dtypes do not follow the
    caller's): dx bf16 within one bf16 ulp, d offsets, dmask and dWeight
    fp32 to 1e-4 of their scale (the column gradient and dWeight summed in
    another order)."""
    args = _bf16_dcn_inputs(8, cuda_device, c=256, cout=256)
    g = torch.randn(args[0].shape[:3] + (256,), device=cuda_device).bfloat16()
    leaves = [a.detach().requires_grad_() for a in args]
    before = [c.launches for c in (dcn.DCN_CONV_FWD_BF16, dcn.DCN_IM2COL_BF16,
                                   dcn.DCN_COL2IM_BF16)]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = dcn.dcn_conv(*leaves, 1)
        grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert [c.launches for c in (dcn.DCN_CONV_FWD_BF16, dcn.DCN_IM2COL_BF16,
                                 dcn.DCN_COL2IM_BF16)] == [n + 1 for n in before]
    ref = dcn.dcn_conv_backward_plain(*args, g)
    assert [x.dtype for x in grads] == [torch.bfloat16] + [torch.float32] * 4
    _within_a_bf16_ulp(grads[0], ref[0], "dx")
    for what, a, r in zip(("doff_y", "doff_x", "dmask", "dweight"), grads[1:], ref[1:]):
        assert_close(a, r, 1e-4, what)


def test_bf16_dcn_refuses_what_its_kernels_do_not_take(cuda_device):
    """bf16 offsets, mask or weight, an fp32 output gradient for bf16 K6, a
    float16 x and an x off its 8-byte boundary raise; nothing launches."""
    x, off_y, off_x, mask, weight = _bf16_dcn_inputs(9, cuda_device, c=32, cout=32)
    counts = [c.launches for c in (dcn.DCN_CONV_FWD_BF16, dcn.DCN_IM2COL_BF16,
                                   dcn.DCN_COL2IM_BF16)]
    for i in range(1, 5):
        args = [x, off_y, off_x, mask, weight]
        args[i] = args[i].bfloat16()
        with pytest.raises(TypeError):
            dcn.dcn_conv(*args, 1)
    with pytest.raises(TypeError):
        dcn.dcn_conv(x.half(), off_y, off_x, mask, weight, 1)
    g = torch.zeros((x.shape[0] * x.shape[1] * x.shape[2], 32), device=cuda_device)
    with pytest.raises(TypeError):
        dcn.dcn_col2im_gw(x, off_y, off_x, mask, g, weight)
    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)[2:]
    shifted = buf.view_as(x).copy_(x)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        dcn.dcn_im2col(shifted, off_y, off_x, mask)
    with pytest.raises(RuntimeError, match="cudaErrorInvalidValue"):
        dcn.dcn_col2im_gw(shifted, off_y, off_x, mask, g.bfloat16(), weight)
    assert counts == [c.launches for c in (dcn.DCN_CONV_FWD_BF16, dcn.DCN_IM2COL_BF16,
                                           dcn.DCN_COL2IM_BF16)]
