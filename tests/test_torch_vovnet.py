"""The port's VoVNet V2-99 (`bevformer_torch/models/vovnet.py`) against the
JAX package's at 64 x 64 (as `test_misc_components.py:39`), through the
weight bridge (`runtime.checkpoint.vovnet_state_dict`), with FrozenBN and
with BatchNorm's running statistics (eval mode); its conv/BN folding
(`runtime.fuse.fuse_conv_bn`) against the unfolded port model and against
JAX's folded one (`test_fuse.py::test_vovnet_fuse_exact`).

Every affine, statistic and weight gets seeded noise, so no BN is an
identity. Tolerance: 1e-4 of each output's scale (fp32 convolutions summed
in another order over 16 blocks of 7 convs each; JAX's own fold test holds
1e-4). Its convs run outside cuDNN forward and backward, and its
train-mode gradients match JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tpu.models.vovnet import VoVNet as JaxVoVNet
from bevformer_tpu.runtime.fuse import fuse_conv_bn as jax_fuse_conv_bn
from bevformer_torch.models.resnet import FrozenBN
from bevformer_torch.models.vovnet import V2_99, VoVNet
from bevformer_torch.runtime.checkpoint import vovnet_state_dict
from bevformer_torch.runtime.fuse import fuse_conv_bn
from bevformer_torch.tools.bench_vovnet import in_cudnn
from tests.torch_port_helpers import assert_close, t, to_numpy_tree

TOL = 1e-4


def _noisy(tree, rng):
    """Seeded noise on every float leaf; variances kept positive."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        else:
            v = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            out[k] = np.abs(v) + 0.5 if k == "var" else v
    return out


@pytest.fixture(scope="module", params=["frozen", "bn"])
def pair(request):
    norm = request.param
    rng = np.random.RandomState(0)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    jmod = JaxVoVNet(out_indices=(0, 1, 2, 3), norm=norm)
    variables = to_numpy_tree(jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x)))
    variables = _noisy(variables, rng)
    if "batch_stats" in variables:
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    apply = jax.jit(lambda v, x: jmod.apply(v, x, train=False))
    expect = [np.asarray(o) for o in apply(variables, jnp.asarray(x))]
    model = VoVNet(out_indices=(0, 1, 2, 3), norm=norm).eval()
    model.load_state_dict({k: t(v) for k, v in vovnet_state_dict(variables).items()})
    return norm, model, variables, x, expect, apply


def test_vovnet_matches_jax(pair):
    norm, model, _, x, expect, _ = pair
    with torch.no_grad():
        outs = model(t(x).permute(0, 3, 1, 2))
    # strides 4, 8, 16, 32; channels 256, 512, 768, 1024 for V2-99
    assert [tuple(o.shape) for o in outs] == [
        (1, c, 64 // s, 64 // s) for c, s in zip(V2_99["concat_ch"], (4, 8, 16, 32))]
    for i, (o, e) in enumerate(zip(outs, expect)):
        assert_close(o.permute(0, 2, 3, 1), e, TOL, f"{norm} stage {i + 2}")


def test_vovnet_state_dict_is_complete(pair):
    norm, model, variables, *_ = pair
    sd = vovnet_state_dict(variables)
    assert set(sd) == set(model.state_dict()) - {
        k for k in model.state_dict() if k.endswith("num_batches_tracked")}
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables))
    assert sum(v.size for v in sd.values()) == n_jax
    if norm == "frozen":
        assert sum(isinstance(m, FrozenBN) for m in model.modules()) == 3 + 16 * 6


def test_vovnet_fold_matches_unfolded_and_jax(pair):
    norm, model, variables, x, expect, apply = pair
    folded = VoVNet(out_indices=(0, 1, 2, 3), norm=norm).eval()
    folded.load_state_dict(model.state_dict())
    fuse_conv_bn(folded)
    assert not any(isinstance(m, (FrozenBN, torch.nn.BatchNorm2d)) for m in folded.modules())
    jax_folded = [np.asarray(o) for o in apply(
        jax.tree_util.tree_map(np.asarray, jax_fuse_conv_bn(variables)), jnp.asarray(x))]
    with torch.no_grad():
        xin = t(x).permute(0, 3, 1, 2)
        ours, ref = folded(xin), model(xin)
    for i, (o, r, j, e) in enumerate(zip(ours, ref, jax_folded, expect)):
        assert_close(o, r, TOL, f"{norm} folded vs unfolded stage {i + 2}")
        assert_close(o.permute(0, 2, 3, 1), j, TOL, f"{norm} folded vs JAX folded stage {i + 2}")
        assert_close(j, e, TOL, f"{norm} JAX folded vs unfolded stage {i + 2}")


def _conv_ops(model, x):
    """(op, cuDNN enabled) of every aten convolution and convolution_backward
    call in one train-mode forward and backward of `model`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.convolution.default,
                        torch.ops.aten.convolution_backward.default):
                seen.append((func.__name__, torch.backends.cudnn.enabled))
            return func(*args, **(kwargs or {}))

    with Record():
        sum(o.sum() for o in model(x)).backward()
    return seen


def test_vovnet_convs_run_outside_cudnn_forward_and_backward():
    """Every conv of a train-mode forward and its backward runs with cuDNN
    off (`NativeConv2d`). The same model on `nn.Conv2d`'s own forward (as
    `tools/bench_vovnet.py` binds it to time cuDNN), the control, runs its
    backward under the global flags (cuDNN on)."""
    torch.manual_seed(0)
    model = VoVNet(out_indices=(1, 2, 3), norm="bn").train()
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    x = torch.randn(1, 3, 64, 64)
    seen = _conv_ops(model, x)
    assert [n for n, _ in seen].count("convolution.default") == n_convs
    assert [n for n, _ in seen].count("convolution_backward.default") == n_convs
    assert not any(enabled for _, enabled in seen), seen
    in_cudnn(model)
    assert torch.backends.cudnn.enabled
    control = _conv_ops(model, x)
    assert len(control) == 2 * n_convs and all(enabled for _, enabled in control)


@pytest.mark.parametrize("norm", ["frozen", "bn"])
def test_vovnet_train_gradients_match_jax(norm):
    """A train-mode forward (BatchNorm on batch statistics) and the gradient
    of a seeded weighting of stage 2's output, against JAX's through the
    weight bridge; tolerance 1e-4 of each gradient's scale (as the
    forward's). The stem and stage 2 hold every kind of conv the model has
    (3x3 at strides 1 and 2, the 1x1 concat, eSE's biased 1x1). Deeper, a
    ReLU input within rounding of 0 falls on one side in one fp32 run and
    on the other in another: through stage 3 at this size the port's and
    JAX's fp32 gradients are each some 7% of scale from the fp64 one."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jmod = JaxVoVNet(out_indices=(0,), norm=norm)
    variables = _noisy(to_numpy_tree(jax.jit(jmod.init)(jax.random.PRNGKey(3), jnp.asarray(x))),
                       rng)
    stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, variables.get("batch_stats", {}))
    (out,) = jax.eval_shape(lambda: jmod.apply(variables, jnp.asarray(x), train=True,
                                               mutable=["batch_stats"])[0])
    w = rng.randn(*out.shape).astype(np.float32)

    def loss(params, x):
        (o,), _ = jmod.apply({"params": params, "batch_stats": stats}, x, train=True,
                             mutable=["batch_stats"])
        return (o * w).sum()

    dparams, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    expect = vovnet_state_dict({"params": to_numpy_tree(dparams), "batch_stats": stats})

    model = VoVNet(out_indices=(0,), norm=norm).train()
    model.load_state_dict({k: t(v) for k, v in vovnet_state_dict(
        {"params": variables["params"], "batch_stats": stats}).items()})
    xin = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    (o,) = model(xin)
    (o.permute(0, 2, 3, 1) * t(w)).sum().backward()
    reached = [n for n, p in model.named_parameters() if p.grad is not None]
    assert reached == [n for n, _ in model.named_parameters()
                       if n.startswith(("stem", "stage2"))]
    for name in reached:
        assert_close(model.get_parameter(name).grad, expect[name], TOL, f"{norm} d {name}")
    assert_close(xin.grad.permute(0, 2, 3, 1), np.asarray(dx), TOL, f"{norm} d input")
