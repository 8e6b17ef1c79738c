"""The bf16 DCN (`kernels/dcn.py` on a bf16 x, `ModulatedDeformConv` under
bf16 autocast) and bevformer_small in bf16, against the JAX package on the
CPU.

* The bf16 `ModulatedDeformConv` against JAX's `ModulatedDeformConv(
  impl="off", dtype=bfloat16)` on the same weights and bf16 input, within
  MODULE_ULPS bf16 ulps at the output's scale: the port's offset conv runs
  in bf16 (as JAX's fused bf16 mode runs it), JAX's exact path runs it in
  fp32, so the sample positions differ by bf16 rounding (~2^-9 of each
  offset); the two sides also differ by the port's rounding of the column
  and the weight to bf16. JAX's own bf16 output is 3.6-4.5 ulps from its
  fp32 one here.
* At one tiny shape with offsets inside +-clip_y, the plain bf16 conv
  against `dcn_conv_pallas(..., compute_dtype=bfloat16)` run in interpret
  mode, within PALLAS_ULPS (the JAX kernel rounds its bilinear x-weights to
  bf16 as well).
* The plain versions' bf16 semantics: the column is the fp32 column
  rounded once; the output is the fp32 sum of the rounded column and
  weight, rounded once; the backward the card runs (im2col and the fp32
  dWeight product, then `dcn_col2im_gw` on the bf16 output gradient and
  the weight) equals autograd through the plain conv, as does the same
  with the column gradient's fp32 product and col2im; dx is bf16, the
  rest fp32.
* The DCN call sites of a bf16 frame and of a bf16 training step hand the
  kernels what their CUDA wrappers accept (the wrappers' own checks in
  front of the plain versions, through the kernels' autograd Function):
  the backward's dWeight product is fp32 under the caller's autocast, and
  its column gradient is never made outside `dcn_col2im_gw`; what that
  wrapper refuses.
* FrozenBN keeps a bf16 input's dtype under autocast and is unchanged,
  bitwise, in fp32.
* bevformer_small's mini detector (caffe R10 with DCN in stages 3-4) at
  dtype=bfloat16 against JAX's bf16 model (`fused_dcn="off"`) under the
  rule of `tests/test_torch_bf16.py`: rel_err(port bf16, JAX bf16) <= 2 x
  rel_err(JAX bf16, JAX fp32) for each output, the loss terms and each
  gradient group. bevformer_base's is `tests/test_torch_bf16_base.py`.
* The bf16 DCN's roofline costs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.kernels.dcn_pallas import dcn_conv_pallas
from bevformer_tpu.models.resnet import ModulatedDeformConv as JaxDCN
from bevformer_torch.data import SyntheticVideo, train_batch
from bevformer_torch.device import precision
from bevformer_torch.kernels import dcn
from bevformer_torch.models import resnet
from bevformer_torch.models.resnet import FrozenBN
from bevformer_torch.runtime import Trainer, VideoEvaluator, build_model, init_state_dict
from bevformer_torch.tools import roofline
from tests.test_torch_bf16 import (
    GROUPS,
    OUTPUTS,
    bf16_runs,
    check_frames,
    check_gradients,
    check_loss_terms,
)
from tests.test_torch_dcn import _port_dcn
from tests.test_torch_presets import mini
from tests.torch_port_helpers import bf16_ulps, port_config, t

MODULE_ULPS = 8.0
PALLAS_ULPS = 2.0


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_module_matches_jax_bf16(stride):
    rng = np.random.RandomState(10 + stride)
    b, h, w, cin, cout = 2, 9, 11, 64, 48
    xb = _bf16(rng.randn(b, h, w, cin).astype(np.float32))
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jmod = JaxDCN(cout, stride=stride, impl="off", dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jx))
    params = {"params": {
        "kernel": params["params"]["kernel"],
        "conv_offset": {
            "kernel": (rng.randn(3, 3, cin, 27) * 0.2).astype(np.float32),
            "bias": (rng.randn(27) * 1.0).astype(np.float32),
        },
    }}
    ref = np.asarray(jmod.apply(params, jx).astype(jnp.float32))
    mod = _port_dcn(params["params"], cin, cout, stride)
    with torch.no_grad(), precision("bfloat16", "cpu"):
        out = mod(xb.permute(0, 3, 1, 2))
    assert out.dtype == torch.bfloat16
    err = bf16_ulps(out.float().permute(0, 2, 3, 1).numpy(), ref)
    assert err <= MODULE_ULPS, f"stride {stride}: {err:.2f} bf16 ulps"


def test_bf16_plain_matches_jax_pallas_kernel_in_interpret_mode():
    rng = np.random.RandomState(30)
    b, h, w, c, cout = 2, 9, 11, 64, 48
    x = _bf16(rng.randn(b, h, w, c).astype(np.float32))
    off_y = np.clip(rng.randn(b, h, w, 9) * 1.5, -5, 5).astype(np.float32)  # inside clip_y 6
    off_x = (rng.randn(b, h, w, 9) * 3).astype(np.float32)
    mask = rng.rand(b, h, w, 9).astype(np.float32)
    weight = (rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(np.float32)
    ref = dcn_conv_pallas(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                          *map(jnp.asarray, (off_y, off_x, mask, weight)),
                          compute_dtype=jnp.bfloat16)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1).reshape(b, h, w, cout)
    ours = dcn.dcn_conv_plain(x, t(off_y), t(off_x), t(mask), t(weight))
    assert ours.dtype == torch.bfloat16
    err = bf16_ulps(ours.float().numpy(), ref)
    assert err <= PALLAS_ULPS, f"{err:.2f} bf16 ulps"


def _inputs(seed, b=2, h=6, w=7, c=32, cout=40):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(b, h, w, c).astype(np.float32))
    off_y, off_x = (t((rng.randn(b, h, w, 9) * 3).astype(np.float32)) for _ in "yx")
    mask = t(rng.rand(b, h, w, 9).astype(np.float32))
    weight = t((rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(np.float32))
    g = _bf16(rng.randn(b, h, w, cout).astype(np.float32))
    return x, off_y, off_x, mask, weight, g


def test_bf16_plain_column_and_output_round_once():
    """The bf16 column is the fp32 column of the same (bf16-valued) x
    rounded once; the output is the fp32 sum of the rounded column times
    the rounded weight, rounded once (within 1 ulp of that sum in float64
    rounded: fp32 sums in another order)."""
    x, off_y, off_x, mask, weight, _ = _inputs(1)
    cols = dcn.dcn_im2col_plain(x, off_y, off_x, mask)
    assert cols.dtype == torch.bfloat16
    assert torch.equal(cols, dcn.dcn_im2col_plain(x.float(), off_y, off_x, mask).bfloat16())
    out = dcn.dcn_conv_plain(x, off_y, off_x, mask, weight)
    exact = cols.double() @ weight.bfloat16().double()
    assert out.dtype == torch.bfloat16
    assert bf16_ulps(out.float().reshape(exact.shape).numpy(), exact.numpy()) <= 1.0


def test_bf16_backward_decomposes_into_im2col_and_col2im():
    """The bf16 backward as plain products and col2im (the bf16 column,
    dWeight = cols^T g and dCols = g W_bf16^T in fp32, col2im with an fp32
    column gradient: what `dcn_col2im_gw_plain` composes), equals autograd
    through the plain bf16 conv: dx bf16 (within 1 ulp: one rounding of
    fp32 sums in another order), d offsets, dmask and dWeight fp32 to 1e-5
    of scale."""
    x, off_y, off_x, mask, weight, g = _inputs(2)
    ref = dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g)
    assert [r.dtype for r in ref] == [torch.bfloat16] + [torch.float32] * 4
    gm = g.float().reshape(-1, weight.shape[1])
    cols = dcn.dcn_im2col(x, off_y, off_x, mask)
    dweight = cols.float().t() @ gm
    dcols = gm @ weight.bfloat16().float().t()
    ours = (*dcn.dcn_col2im(x, off_y, off_x, mask, dcols), dweight)
    assert ours[0].dtype == torch.bfloat16
    assert bf16_ulps(ours[0].float().numpy(), ref[0].float().numpy()) <= 1.0
    for name, a, r in zip(("doff_y", "doff_x", "dmask", "dweight"), ours[1:], ref[1:]):
        assert a.dtype == torch.float32, name
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= 1e-5 * scale, name


def test_bf16_backward_decomposes_into_im2col_and_col2im_gw():
    """The backward the card runs on a bf16 x (`_DCNConv.backward`: the bf16
    column and dWeight = cols^T g in fp32, then `dcn_col2im_gw` on the bf16
    output gradient and the weight), in plain versions, equals autograd
    through the plain bf16 conv: dx bf16 within 1 ulp, d offsets, dmask and
    dWeight fp32 to 1e-5 of scale."""
    x, off_y, off_x, mask, weight, g = _inputs(4, cout=48)
    ref = dcn.dcn_conv_backward_plain(x, off_y, off_x, mask, weight, g)
    gm = g.reshape(-1, weight.shape[1])
    assert gm.dtype == torch.bfloat16
    cols = dcn.dcn_im2col(x, off_y, off_x, mask)
    ours = (*dcn.dcn_col2im_gw(x, off_y, off_x, mask, gm, weight), cols.float().t() @ gm.float())
    assert ours[0].dtype == torch.bfloat16
    assert bf16_ulps(ours[0].float().numpy(), ref[0].float().numpy()) <= 1.0
    for name, a, r in zip(("doff_y", "doff_x", "dmask", "dweight"), ours[1:], ref[1:]):
        assert a.dtype == torch.float32, name
        scale = float(r.abs().max())
        assert float((a - r).abs().max()) <= 1e-5 * scale, name


def test_bf16_col2im_gw_plain_is_col2im_of_the_fp32_column_gradient():
    """`dcn_col2im_gw` on CPU tensors is its plain version: `dcn_col2im_plain`
    of g W_bf16^T in fp32, bitwise, inside bf16 autocast too (the product
    stays fp32)."""
    x, off_y, off_x, mask, weight, g = _inputs(5, cout=48)
    gm = g.reshape(-1, 48)
    dcols = gm.float() @ weight.bfloat16().float().t()
    ref = dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols)
    with precision("bfloat16", "cpu"):
        ours = dcn.dcn_col2im_gw(x, off_y, off_x, mask, gm, weight)
    for a, r in zip(ours, ref):
        assert a.dtype == r.dtype and torch.equal(a, r)


def test_bf16_col2im_gw_refuses_what_its_kernel_does_not_take():
    """The wrapper's checks (`_check_col2im_gw`, run before each launch):
    an fp32 g, a g of the wrong shape, Cout not a multiple of 16, an fp32
    x, a bf16 weight and a strided g raise; the model's arguments pass."""
    x, off_y, off_x, mask, weight, g = _inputs(6, cout=48)
    gm = g.reshape(-1, 48)
    dcn._check_col2im_gw(x, off_y, off_x, mask, gm, weight, 1)
    with pytest.raises(TypeError):
        dcn._check_col2im_gw(x, off_y, off_x, mask, gm.float(), weight, 1)
    with pytest.raises(ValueError, match="g must be"):
        dcn._check_col2im_gw(x, off_y, off_x, mask, gm[1:], weight, 1)
    x40, off40, _, _, w40, g40 = _inputs(6, cout=40)
    with pytest.raises(ValueError, match="multiple of 16"):
        dcn._check_col2im_gw(x40, off40, off40, off40, g40.reshape(-1, 40), w40, 1)
    with pytest.raises(TypeError):
        dcn._check_col2im_gw(x.float(), off_y, off_x, mask, gm, weight, 1)
    with pytest.raises(TypeError):
        dcn._check_col2im_gw(x, off_y, off_x, mask, gm, weight.bfloat16(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        dcn._check_col2im_gw(x, off_y, off_x, mask, torch.cat([gm, gm], 1)[:, ::2], weight, 1)


def test_bf16_col2im_plain_sums_in_fp32_and_rounds_dx_once():
    x, off_y, off_x, mask, _, _ = _inputs(3)
    dcols = torch.randn(x.shape[0] * x.shape[1] * x.shape[2], 9 * x.shape[3],
                        generator=torch.Generator().manual_seed(0))
    ours = dcn.dcn_col2im_plain(x, off_y, off_x, mask, dcols)
    ref = dcn.dcn_col2im_plain(x.float(), off_y, off_x, mask, dcols)
    assert torch.equal(ours[0], ref[0].bfloat16())
    for a, r in zip(ours[1:], ref[1:]):
        assert torch.equal(a, r)


def _small_bf16_model():
    cfg = port_config(mini("bevformer_small")).replace(dtype="bfloat16")
    return cfg, build_model(cfg, init_state_dict(cfg, seed=0), "cpu")


def test_bf16_dcn_call_sites_meet_the_kernel_contract(monkeypatch):
    """Every DCN call of a bf16 frame and of a bf16 training step hands the
    kernels what their CUDA wrappers accept: a bf16 x, fp32 offsets, mask
    and weight, all contiguous; the backward's K5 a bf16 x and K6
    (`dcn_col2im_gw`) a bf16 x and the bf16 output gradient with the
    weight, though the step runs backward inside bf16 autocast (checked
    with the wrappers' own checks in front of the plain versions, through
    the kernels' autograd Function); dWeight comes back fp32. Outside the
    wrappers, the bf16 route makes no [B*OH*OW, 9C] matrix product (the
    column gradient) and never calls the fp32 route's `dcn_col2im`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = {"fwd": 0, "im2col": 0, "col2im": 0, "col2im_gw": 0}
    bf16 = (torch.bfloat16,)
    inside = [False]  # in a checked plain version, whose own products do not count
    columns = set()  # (B*OH*OW, 9C) of every DCN call
    products = []  # shapes of the matrix products made outside the wrappers

    def plain(fn, *args):
        inside[0] = True
        try:
            return fn(*args)
        finally:
            inside[0] = False

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not inside[0] and func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm,
                                                         torch.ops.aten.bmm):
                products.append(tuple(out.shape[-2:]))
            return out

    def fwd_checked(x, off_y, off_x, mask, weight, stride):
        dcn._check(x, off_y, off_x, mask, weight, stride, bf16)
        calls["fwd"] += 1
        columns.add((off_y.shape[0] * off_y.shape[1] * off_y.shape[2], weight.shape[0]))
        return plain(dcn.dcn_conv_plain, x, off_y, off_x, mask, weight, stride)

    def im2col_checked(x, off_y, off_x, mask, stride=1):
        dcn._check_sampling(x, off_y, off_x, mask, stride, bf16)
        calls["im2col"] += 1
        return plain(dcn.dcn_im2col_plain, x, off_y, off_x, mask, stride)

    def col2im_checked(x, off_y, off_x, mask, dcols, stride=1):
        calls["col2im"] += 1
        return plain(dcn.dcn_col2im_plain, x, off_y, off_x, mask, dcols, stride)

    def col2im_gw_checked(x, off_y, off_x, mask, g, weight, stride=1):
        dcn._check_col2im_gw(x, off_y, off_x, mask, g, weight, stride)
        calls["col2im_gw"] += 1
        return plain(dcn.dcn_col2im_gw_plain, x, off_y, off_x, mask, g, weight, stride)

    weights = []

    def through_function(x, off_y, off_x, mask, weight, stride):
        weights.append(weight)
        return dcn._DCNConv.apply(x, off_y, off_x, mask, weight, stride)

    monkeypatch.setattr(dcn, "_launch_fwd", fwd_checked)
    monkeypatch.setattr(dcn, "dcn_im2col", im2col_checked)
    monkeypatch.setattr(dcn, "dcn_col2im", col2im_checked)
    monkeypatch.setattr(dcn, "dcn_col2im_gw", col2im_gw_checked)
    monkeypatch.setattr(resnet, "dcn_conv", through_function)
    cfg, model = _small_bf16_model()
    VideoEvaluator(model).infer_frame(SyntheticVideo(cfg, (1,), seed=1, device="cpu")
                                      .get_test_sample(0))
    per_frame = sum(resnet.ARCH_SETTINGS[cfg.backbone_depth][s] for s in cfg.backbone_dcn_stages)
    assert per_frame == 2 and calls == dict(fwd=per_frame, im2col=0, col2im=0, col2im_gw=0)
    calls.update(dict.fromkeys(calls, 0))
    trainer = Trainer(model, total_steps=10)
    batch = train_batch(cfg, seed=2, device="cpu")
    with Products():
        out = trainer.step(batch)
    assert all(np.isfinite(v) for v in out.values()), out
    assert calls == dict(fwd=2 * per_frame, im2col=per_frame, col2im=0, col2im_gw=per_frame)
    grads = [w.grad for w in model.parameters() if w.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    # the step's own products were seen (dWeight's [9C, Cout] among them)
    assert columns and products
    assert not columns & set(products), (columns, sorted(set(products)))


def test_frozen_bn_keeps_bf16_and_is_unchanged_in_fp32():
    bn = FrozenBN(8)
    gen = torch.Generator().manual_seed(0)
    for name in ("weight", "bias", "running_mean"):
        getattr(bn, name).copy_(torch.randn(8, generator=gen))
    bn.running_var.copy_(torch.rand(8, generator=gen) + 0.5)
    x = torch.randn(2, 8, 3, 4, generator=gen)
    mul = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    add = bn.bias - bn.running_mean * mul
    assert torch.equal(bn(x), x * mul[:, None, None] + add[:, None, None])
    with precision("bfloat16", "cpu"):
        y = bn(x.bfloat16())
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, x.bfloat16() * mul.bfloat16()[:, None, None]
                       + add.bfloat16()[:, None, None])


@pytest.mark.parametrize("args", [(6, 58, 100, 256, 256), (6, 29, 50, 512, 512)],
                         ids=["layer3", "layer4"])
def test_roofline_bf16_dcn_counts_x_output_and_column_at_two_bytes(args):
    """bf16 K2, K5 and K6: x, K2's output, K5's column and K6's dx at 2
    bytes an element; offsets, mask, the weight and K6's column gradient at
    4. K2's contraction is one bf16 product (989 TFLOP/s) per multiply-add,
    so operations bound it at a third of TF32's time over 3 products."""
    b, h, w, c, cout = args
    taps, x2, offsets = b * h * w * 9, b * h * w * c * 2, 3 * b * h * w * 9 * 4
    k2 = roofline.dcn_conv(b, h, w, c, cout, itemsize=2)
    assert k2.bytes == x2 + offsets + 9 * c * cout * 4 + b * h * w * cout * 2
    assert k2.bf16_flops == 2 * taps * c * cout and k2.tf32_flops == 0
    assert k2.bound_by == "operations"
    assert k2.bound_ms == pytest.approx(2 * taps * c * cout / 989e12 * 1e3)
    k5 = roofline.dcn_im2col(b, h, w, c, itemsize=2)
    assert k5.bytes == x2 + offsets + taps * c * 2
    assert k5.bytes < roofline.dcn_im2col(b, h, w, c).bytes * 0.51
    k6 = roofline.dcn_col2im(b, h, w, c, itemsize=2)
    assert k6.bytes == 2 * (x2 + offsets) + taps * c * 4
    assert k6.flops == roofline.dcn_col2im(b, h, w, c).flops
    assert "989 TFLOP/s bf16" in roofline.PEAKS


# ---------------------------------------------------------------- mini small

@pytest.fixture(scope="module")
def runs():
    jcfg32 = mini("bevformer_small")
    return bf16_runs(jcfg32, jcfg32.replace(dtype="bfloat16"))


@pytest.mark.parametrize("key", OUTPUTS)
def test_small_bf16_frames_within_jaxs_own_bf16_gap(runs, key):
    check_frames(runs, key)


def test_small_bf16_loss_terms_within_jaxs_own_bf16_gap(runs):
    check_loss_terms(runs)


@pytest.mark.parametrize("group", [g for g, _ in GROUPS])
def test_small_bf16_gradients_within_jaxs_own_bf16_gap(runs, group):
    check_gradients(runs, group)
