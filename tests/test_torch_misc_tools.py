"""The port's misc, converter and analysis tools (`bevformer_torch/tools/
misc`, `model_converters`, `analysis_tools`) and utils
(`bevformer_torch/utils`), each run as a user runs it (`python3 -m ...`, a
process of its own) on a tiny synthetic root, against the JAX package's
tool of the same name (`tools/...`) on the same inputs.

What is held, and how closely:
* print_config, get_params, analyze_logs' cal_train_time: the printed
  lines equal the JAX tool's;
* visualize_results (cv2), analysis_tools/visual and analyze_logs'
  plot_curve (matplotlib): the image files equal the JAX tool's byte for
  byte (the same drawing calls on the same numbers);
* browse_dataset: the rendered samples within 2 levels of 255 at every
  pixel and a mean difference under 0.05 (the port's pipeline runs in
  torch and matches JAX's to 1e-3 on the 0-255 scale, `test_torch_data`;
  a value on a rounding edge can move one level before matplotlib
  resamples it);
* fuse_conv_bn: every folded conv and BN equals JAX's
  `runtime/fuse.py::fuse_conv_bn` of the same weights to 1e-6 of scale,
  and the folded checkpoint's frame equals the unfolded one's to 1e-4 of
  scale (fp32 rounding of the folded weights);
* publish_model: the weights bitwise, nothing but meta and state_dict;
* utils: `save_tensor` writes JAX's image grid byte for byte; `run_time`
  prints the running mean.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from bevformer_torch.configs import DataConfig, get_config
from bevformer_torch.data import SyntheticVideo, synth
from bevformer_torch.runtime import VideoEvaluator, build_model, init_state_dict
from bevformer_torch.runtime.checkpoint import load_reference_pth
from tests.torch_port_helpers import assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["backbone_depth=10", "bev_h=8", "bev_w=8", "encoder_layers=1", "decoder_layers=1",
        "num_query=20", "data.raw_size=(64,96)"]
FRAME_TOL = 1e-4
FOLD_TOL = 1e-6


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def port_tool(module, *args, cwd=ROOT):
    proc = subprocess.run([sys.executable, "-m", f"bevformer_torch.tools.{module}", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def jax_tool(script, *args, cwd=ROOT):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", script), *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _tiny_cfg():
    return get_config("bevformer_base", backbone_depth=10, bev_h=8, bev_w=8, encoder_layers=1,
                      decoder_layers=1, num_query=20, data=DataConfig(raw_size=(64, 96)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A synthetic root at the configs' camera size (1600 x 900), 1 train
    and 1 val scene of 2 frames; the val split's results json; a
    checkpoint of the tiny config in `tools.train`'s layout; a train log."""
    base = tmp_path_factory.mktemp("tools")
    data = str(base / "data")
    synth.generate(data, num_scenes=2, frames_per_scene=2, num_objects=10, seed=3)
    val = os.path.join(data, "nuscenes_infos_temporal_val.pkl")
    import pickle

    with open(val, "rb") as f:
        infos = pickle.load(f)["infos"]
    rng = np.random.RandomState(0)
    results = []
    for info in infos:
        n = 12
        boxes = np.concatenate([rng.uniform(-40, 40, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                                rng.uniform(0.5, 5, (n, 3)), rng.uniform(-3, 3, (n, 1)),
                                rng.randn(n, 2)], 1)
        results.append(dict(token=info["token"], boxes_3d=boxes.tolist(),
                            scores_3d=rng.rand(n).tolist(), labels_3d=rng.randint(0, 10, n).tolist()))
    res_path = str(base / "results.json")
    with open(res_path, "w") as f:
        json.dump(results, f)

    cfg = _tiny_cfg()
    sd = init_state_dict(cfg, seed=0)
    ckpt = str(base / "iter_3.pth")
    torch.save(dict(meta=dict(epoch=1, iter=3, config="bevformer_base"),
                    state_dict={k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                    optimizer=dict(state={}, param_groups=[]), scheduler={}, rng={}, step=3),
               ckpt)
    log = str(base / "train_log.jsonl")
    with open(log, "w") as f:
        for step in range(0, 40, 5):
            f.write(json.dumps(dict(step=step, time=0.37 * step + 0.01 * (step % 3),
                                    total=30.0 / (1 + step), loss_cls=2.0 - 0.01 * step)) + "\n")
    return dict(base=base, data=data, results=res_path, ckpt=ckpt, log=log)


@pytest.mark.parametrize("options", [[], ["bev_h=50", "data.scale=0.5", "optim.lr=1e-4"]])
def test_print_config_matches_jax(options):
    ours = json.loads(port_tool("misc.print_config", "bevformer_tiny",
                                *(["--cfg-options", *options] if options else [])))
    if options:  # the JAX tool's own override syntax
        ref = json.loads(jax_tool("misc/print_config.py", "bevformer_tiny", "--cfg-options",
                                  *options))
    else:
        ref = json.loads(jax_tool("misc/print_config.py", "bevformer_tiny"))
    # the port's config holds the JAX config's fields but those only the
    # TPU needs (ROADMAP: not ported) and the few it hard-codes
    assert set(ours) <= set(ref)
    for key, value in ours.items():
        assert value == ref[key], key


def test_get_params_matches_jax(root):
    assert (port_tool("analysis_tools.get_params", "bevformer_tiny")
            == jax_tool("analysis_tools/get_params.py", "bevformer_tiny"))
    n = sum(v.numel() for v in load_reference_pth(root["ckpt"]).values())
    assert port_tool("analysis_tools.get_params", "--pth", root["ckpt"]).strip() == \
        f"{n / 1e6:.2f}M parameters"


def test_analyze_logs_matches_jax(root):
    assert (port_tool("analysis_tools.analyze_logs", "cal_train_time", root["log"])
            == jax_tool("analysis_tools/analyze_logs.py", "cal_train_time", root["log"]))
    ours, ref = str(root["base"] / "ours.png"), str(root["base"] / "ref.png")
    port_tool("analysis_tools.analyze_logs", "plot_curve", root["log"], "--keys", "total",
              "loss_cls", "--out", ours)
    jax_tool("analysis_tools/analyze_logs.py", "plot_curve", root["log"], "--keys", "total",
             "loss_cls", "--out", ref)
    assert open(ours, "rb").read() == open(ref, "rb").read()


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for name in names:
        assert open(os.path.join(a, name), "rb").read() == \
            open(os.path.join(b, name), "rb").read(), name
    return names


def test_visualize_results_matches_jax(root):
    ours, ref = str(root["base"] / "vis_ours"), str(root["base"] / "vis_ref")
    args = ["--result", root["results"], "--data-root", root["data"], "--score-thr", "0.2"]
    port_tool("misc.visualize_results", *args, "--show-dir", ours)
    jax_tool("misc/visualize_results.py", *args, "--show-dir", ref)
    assert len(_same_files(ours, ref)) == 2


def test_analysis_visual_matches_jax(root):
    ours, ref = str(root["base"] / "viz_ours"), str(root["base"] / "viz_ref")
    args = [root["results"], "--data-root", root["data"], "--gt", "--score-thr", "0.2"]
    port_tool("analysis_tools.visual", *args, "--out-dir", ours)
    jax_tool("analysis_tools/visual.py", *args, "--out-dir", ref)
    assert len(_same_files(ours, ref)) == 2


def test_browse_dataset_matches_jax(root):
    ours, ref = str(root["base"] / "browse_ours"), str(root["base"] / "browse_ref")
    args = ["bevformer_tiny", "--data-root", root["data"], "--split", "val", "--max-samples",
            "1"]
    port_tool("misc.browse_dataset", *args, "--out-dir", ours, "--device", "cpu")
    jax_tool("misc/browse_dataset.py", *args, "--out-dir", ref)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(ref)) == ["sample_0000.png"]
    a = cv2.imread(os.path.join(ours, names[0])).astype(int)
    b = cv2.imread(os.path.join(ref, names[0])).astype(int)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


def _frame(cfg, sd):
    model = build_model(cfg, sd, "cpu")
    video = SyntheticVideo(cfg, (1,), seed=0, device="cpu")
    return VideoEvaluator(model).run(video, progress_every=0)[0]


def test_fuse_conv_bn_folds_as_jax_and_keeps_the_frame(root):
    import jax.numpy as jnp

    from bevformer_tpu.runtime.fuse import fuse_conv_bn as jax_fuse

    out = str(root["base"] / "fused.pth")
    port_tool("misc.fuse_conv_bn", root["ckpt"], out, "--cfg-options", *TINY, "--device", "cpu")
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    assert sorted(ckpt) == ["meta", "state_dict"] and ckpt["meta"]["fused_conv_bn"]
    folded, orig = ckpt["state_dict"], load_reference_pth(root["ckpt"])
    assert sorted(folded) == sorted(orig)

    # JAX's fold of the same (conv, BN) pairs: conv1/bn1 nodes of numpy leaves
    pairs = sorted({k[: -len(".running_var")] for k in orig if k.endswith(".running_var")})
    tree, names = {}, {}
    for bn in pairs:
        parent, leaf = bn.rsplit(".", 1)
        conv = f"{parent}.{dict(bn1='conv1', bn2='conv2', bn3='conv3').get(leaf, '0')}"
        names[bn] = conv
        tree[bn] = {"conv1": {"kernel": jnp.asarray(orig[f"{conv}.weight"].permute(2, 3, 1, 0)
                                                     .numpy())},
                    "bn1": {"scale": orig[f"{bn}.weight"].numpy(), "bias": orig[f"{bn}.bias"].numpy(),
                            "mean": orig[f"{bn}.running_mean"].numpy(),
                            "var": orig[f"{bn}.running_var"].numpy()}}
    ref = jax_fuse({"params": tree})["params"]
    assert len(pairs) > 10
    for bn, conv in names.items():
        assert_close(folded[f"{conv}.weight"],
                     np.transpose(np.asarray(ref[bn]["conv1"]["kernel"]), (3, 2, 0, 1)),
                     FOLD_TOL, conv)
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            assert_close(folded[f"{bn}.{ours}"], np.asarray(ref[bn]["bn1"][theirs]), FOLD_TOL,
                         f"{bn}.{ours}")

    cfg = _tiny_cfg()
    a, b = _frame(cfg, folded), _frame(cfg, orig)
    for key in ("boxes_3d", "scores_3d"):
        assert_close(a[key], b[key], FRAME_TOL, key)


def test_publish_model_strips_the_training_state(root):
    out = str(root["base"] / "published.pth")
    # the tiny checkpoint is not bevformer_base at full size: --pth checks the keys and shapes
    proc = subprocess.run([sys.executable, "-m", "bevformer_torch.tools.model_converters."
                           "publish_model", root["ckpt"], out, "--pth", "bevformer_base"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, env=_env())
    assert proc.returncode != 0 and "size mismatch" in proc.stderr
    port_tool("model_converters.publish_model", root["ckpt"], out)
    ckpt = torch.load(out, map_location="cpu", weights_only=True)
    assert sorted(ckpt) == ["meta", "state_dict"]
    orig = torch.load(root["ckpt"], map_location="cpu", weights_only=True)["state_dict"]
    assert sorted(ckpt["state_dict"]) == sorted(orig)
    assert all(torch.equal(ckpt["state_dict"][k], v) for k, v in orig.items())
    assert ckpt["meta"]["config"] == "bevformer_base"


def test_save_tensor_matches_jax(tmp_path):
    from bevformer_tpu.utils.visual import save_tensor as jax_save_tensor
    from bevformer_torch.utils import save_tensor

    x = np.random.RandomState(0).rand(2, 5, 16, 12).astype(np.float32)
    for arr in (x, x[0], x[0, 0]):
        ours = save_tensor(torch.from_numpy(arr), str(tmp_path / "ours.png"))
        ref = jax_save_tensor(arr, str(tmp_path / "ref.png"))
        assert open(ours, "rb").read() == open(ref, "rb").read()


def test_run_time_prints_the_running_mean(capsys):
    from bevformer_torch.utils import run_time

    @run_time("twice")
    def twice(x):
        return {"y": [x * 2]}

    out = [twice(torch.ones(3)) for _ in range(3)]
    assert torch.equal(out[-1]["y"][0], torch.full((3,), 2.0))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[-1].startswith("twice: ") and "over 3)" in lines[-1]
