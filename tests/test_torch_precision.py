"""The entry points compute in the config's dtype whatever the caller's TF32
flags: `VideoEvaluator.step` and `Trainer.step` run the model with TF32 off
for cuBLAS matmuls and cuDNN convolutions (under `dtype == "float32"`, the
default, as in the JAX config), and hand the caller's flags back afterwards,
also when the model raises. A dtype other than "float32" and "bfloat16"
raises (bf16 is `tests/test_torch_bf16.py`'s). CPU, tiny size: the flags are
read inside the model's forward."""

import dataclasses

import pytest
import torch

from bevformer_torch.configs import DataConfig, get_config
from bevformer_torch.data import SyntheticVideo, train_batch
from bevformer_torch.device import precision
from bevformer_torch.runtime import Trainer, VideoEvaluator, build_model, init_state_dict

CFG = get_config("bevformer_base", backbone_depth=10, bev_h=8, bev_w=8, encoder_layers=1,
                 decoder_layers=1, num_query=20, max_gt=8,
                 data=DataConfig(raw_size=(64, 96), queue_length=2))


def flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def callers_flags():
    """PyTorch's defaults with TF32 on for both (cuDNN's default is on),
    the test process's own flags restored afterwards."""
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _model(cfg):
    torch.manual_seed(0)
    return build_model(cfg, init_state_dict(cfg, seed=0), "cpu")


def _step(kind, model):
    """One `VideoEvaluator.step` or `Trainer.step` of the tiny model."""
    cfg = model.cfg
    if kind == "eval":
        sample = SyntheticVideo(cfg, (1,), seed=0, device="cpu").get_test_sample(0)
        return VideoEvaluator(model).infer_frame(sample)
    return Trainer(model, total_steps=4, seed=0).step(train_batch(cfg, seed=0, device="cpu"))


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_step_runs_fp32_under_the_callers_tf32_flags(kind, callers_flags):
    model = _model(CFG)
    seen = []
    model.register_forward_pre_hook(lambda m, args: seen.append(flags()))
    _step(kind, model)
    assert seen and all(s == (False, False) for s in seen), seen
    assert flags() == callers_flags


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_step_restores_the_callers_flags_after_a_raise(kind, callers_flags):
    model = _model(CFG)

    def fail(m, args):
        assert flags() == (False, False)
        raise RuntimeError("model failed")

    model.register_forward_pre_hook(fail)
    with pytest.raises(RuntimeError, match="model failed"):
        _step(kind, model)
    assert flags() == callers_flags


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_step_refuses_a_dtype_it_does_not_compute_in(kind, callers_flags):
    model = _model(dataclasses.replace(CFG, dtype="float16"))
    with pytest.raises(NotImplementedError, match="computes in float32 or bfloat16"):
        _step(kind, model)
    assert flags() == callers_flags


def test_precision_nests_and_keeps_flags_that_were_off(callers_flags):
    """A step inside another caller's fp32 region (flags already off) leaves
    them off; an inner region hands the outer one its flags back."""
    with precision("float32"):
        assert flags() == (False, False)
        with precision("float32"):
            assert flags() == (False, False)
        assert flags() == (False, False)
    assert flags() == callers_flags == (True, True)
