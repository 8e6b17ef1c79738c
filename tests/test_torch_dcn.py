"""Port's DCNv2 (`ModulatedDeformConv`, `kernels/dcn.py`) against the JAX
package's exact path (`ModulatedDeformConv(impl="off")`), on the CPU.

Offsets are large (std ~3 px, so |dy| > 2 is common: the JAX fused kernel
would clip those) and many samples fall off the small maps. Tolerance: 1e-4
of the output's scale, for fp32 sums of 9*C terms taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.models.resnet import ModulatedDeformConv as JaxDCN
from bevformer_torch.kernels import dcn
from bevformer_torch.models.resnet import ModulatedDeformConv
from tests.torch_port_helpers import assert_close, t


def _port_dcn(params, cin, cout, stride):
    mod = ModulatedDeformConv(cin, cout, stride)
    k = params["kernel"]
    mod.load_state_dict({
        "weight": t(np.transpose(k.reshape(3, 3, cin, cout), (3, 2, 0, 1))),
        "conv_offset.weight": t(np.transpose(params["conv_offset"]["kernel"], (3, 2, 0, 1))),
        "conv_offset.bias": t(params["conv_offset"]["bias"]),
    })
    return mod


@pytest.mark.parametrize("stride", [1, 2])
def test_modulated_deform_conv_matches_jax(stride):
    rng = np.random.RandomState(10 + stride)
    b, h, w, cin, cout = 2, 9, 11, 32, 48
    x = rng.randn(b, h, w, cin).astype(np.float32)
    jmod = JaxDCN(cout, stride=stride, impl="off")
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = {"params": {
        "kernel": params["params"]["kernel"],
        "conv_offset": {
            "kernel": (rng.randn(3, 3, cin, 27) * 0.2).astype(np.float32),
            "bias": (rng.randn(27) * 1.0).astype(np.float32),
        },
    }}
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))

    mod = _port_dcn(params["params"], cin, cout, stride)
    with torch.no_grad():
        om = mod.conv_offset(t(x).permute(0, 3, 1, 2))
        out = mod(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    off = om[:, :18].numpy()
    assert (np.abs(off[:, 0::2]) > 2).mean() > 0.3, "too few |dy| > 2"
    assert_close(out, ref, 1e-4, f"dcn stride {stride}")


def _plain_inputs(seed, b=2, h=6, w=7, c=32, cout=64, stride=1):
    rng = np.random.RandomState(seed)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(b, h, w, c).astype(np.float32)
    off_y = (rng.randn(b, oh, ow, 9) * 3).astype(np.float32)
    off_x = (rng.randn(b, oh, ow, 9) * 3).astype(np.float32)
    mask = rng.rand(b, oh, ow, 9).astype(np.float32)
    weight = (rng.randn(9 * c, cout) / np.sqrt(9 * c)).astype(np.float32)
    return x, off_y, off_x, mask, weight


def test_wrapper_takes_plain_version_for_cpu_tensors():
    args = [t(a) for a in _plain_inputs(1)]
    before = dcn.dcn_conv.launches
    assert torch.equal(dcn.dcn_conv(*args, 1), dcn.dcn_conv_plain(*args, 1))
    assert dcn.dcn_conv.launches == before


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "channels", "stride"])
def test_wrapper_checks_reject_what_the_kernel_cannot_take(bad):
    x, off_y, off_x, mask, weight = (t(a) for a in _plain_inputs(2))
    stride = 1
    if bad == "dtype":
        mask = mask.double()
    elif bad == "contiguity":
        weight = weight.t().contiguous().t()
    elif bad == "channels":
        x, weight = x[..., :24].contiguous(), weight[: 9 * 24].contiguous()
    else:
        stride = 2
    with pytest.raises((TypeError, ValueError)):
        dcn._check(x, off_y, off_x, mask, weight, stride)
