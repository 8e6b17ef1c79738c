"""Port's caffe-style ResNet with DCN in stages 3-4 and the 4-level FPN
against the JAX package (`fused_dcn` off), on the CPU, through the weight
bridge's `backbone_state_dict` / `neck_state_dict`.

Depth 10 (one block per stage) at base widths. Tolerance: 1e-4 of each
output's scale, for fp32 convolutions summed in another order over 9
layers.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bevformer_tpu.models.fpn import FPN as JaxFPN
from bevformer_tpu.models.resnet import ResNet as JaxResNet
from bevformer_torch.models.fpn import FPN
from bevformer_torch.models.resnet import ResNet
from bevformer_torch.runtime.checkpoint import backbone_state_dict, neck_state_dict
from tests.torch_port_helpers import assert_close, perturb, t, to_numpy_tree

IN_CHANNELS = (512, 1024, 2048)


def test_caffe_dcn_backbone_and_fpn_match_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 96, 160, 3)).astype(np.float32) * 50
    jres = JaxResNet(depth=10, out_indices=(1, 2, 3), dcn_stages=(2, 3),
                     dcn_impl="off", style="caffe")
    jfpn = JaxFPN(in_channels=IN_CHANNELS, out_channels=64, num_outs=4)
    bb = to_numpy_tree(jres.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    # scale the block outputs down as the port's seeded init does, and give
    # the DCN offset convs weights: offsets of ~1 px on these features
    for name, node in bb.items():
        if name.startswith("layer"):
            node["bn3"]["scale"] = node["bn3"]["scale"] * 0.2
    perturb(bb, rng, names=("conv_offset",), std=1e-3)
    feats = jres.apply({"params": bb}, jnp.asarray(x))
    neck = to_numpy_tree(jfpn.init(jax.random.PRNGKey(1), feats)["params"])
    ref = jfpn.apply({"params": neck}, feats)

    res = ResNet(depth=10, out_indices=(1, 2, 3), dcn_stages=(2, 3))
    res.load_state_dict({k: t(v) for k, v in backbone_state_dict(bb, 10, (2, 3)).items()})
    fpn = FPN(IN_CHANNELS, 64, 4)
    fpn.load_state_dict({k: t(v) for k, v in neck_state_dict(neck, 3, 4).items()})
    with torch.no_grad():
        img = t(x).permute(0, 3, 1, 2)
        ours_feats = res(img)
        outs = fpn(ours_feats)

    offsets = []
    hook = res.layer3[0].conv2.conv_offset.register_forward_hook(
        lambda m, i, o: offsets.append(o[:, :18])
    )
    with torch.no_grad():
        res(img)
    hook.remove()
    assert float(offsets[0].abs().mean()) > 0.3, "DCN offsets too small to test"

    for i, (a, b) in enumerate(zip(ours_feats, feats)):
        assert_close(a.permute(0, 2, 3, 1), np.asarray(b), 1e-4, f"C{i + 3}")
    assert [tuple(o.shape[-2:]) for o in outs] == [(12, 20), (6, 10), (3, 5), (2, 3)]
    for i, (a, b) in enumerate(zip(outs, ref)):
        assert_close(a.permute(0, 2, 3, 1), np.asarray(b), 1e-4, f"fpn{i}")
