"""bevformer_base's mini detector (caffe R10 with DCN in stages 3-4, four
FPN levels, 16 x 16 BEV, 2 + 2 layers) at dtype=bfloat16 against the JAX
package's bf16 model (`fused_dcn="off"`) on the CPU, under the rule of
`tests/test_torch_bf16.py`: rel_err(port bf16, JAX bf16) <= 2 x
rel_err(JAX bf16, JAX fp32) for bev_embed, cls and bbox of a 3-frame video,
the loss terms and each gradient group of an eval-mode training step. In a
file of its own so that it runs beside small's
(`tests/test_torch_bf16_dcn.py`) on another worker."""

import pytest

from tests.test_torch_bf16 import (
    GROUPS,
    OUTPUTS,
    bf16_runs,
    check_frames,
    check_gradients,
    check_loss_terms,
)
from tests.test_torch_presets import mini


@pytest.fixture(scope="module")
def runs():
    jcfg32 = mini("bevformer_base")
    return bf16_runs(jcfg32, jcfg32.replace(dtype="bfloat16"))


@pytest.mark.parametrize("key", OUTPUTS)
def test_base_bf16_frames_within_jaxs_own_bf16_gap(runs, key):
    check_frames(runs, key)


def test_base_bf16_loss_terms_within_jaxs_own_bf16_gap(runs):
    check_loss_terms(runs)


@pytest.mark.parametrize("group", [g for g, _ in GROUPS])
def test_base_bf16_gradients_within_jaxs_own_bf16_gap(runs, group):
    check_gradients(runs, group)
