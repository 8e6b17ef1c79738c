"""The port's CLIs and checkpoints, on the CPU at the mini size of
`tests/test_torch_slice.py` (caffe R10 with DCN, 16 x 16 BEV, 2 + 2
layers) and 160 x 96 images.

* A `Trainer` run of k steps, saved, restored into a fresh trainer (other
  weights, other seed) and run m more steps equals k + m uninterrupted
  steps bitwise, dropout and GridMask on, on fixed `train_batch` draws: the
  checkpoint carries the model, AdamW, the schedule and the random
  generators.
* `main([...])` of each CLI in-process with `--device cpu`: create a root,
  train 2 steps, resume to 3, test; the train log, the checkpoints and the
  metrics land where they should. Without `--device cpu` and without a
  card, each raises.
"""

import json
import math
import os

import pytest
import torch

from bevformer_torch.configs import DataConfig, get_config
from bevformer_torch.data import train_batch
from bevformer_torch.runtime import (
    Trainer,
    build_model,
    init_state_dict,
    restore_checkpoint,
    save_checkpoint,
)
from bevformer_torch.tools import create_data, test as test_cli, train as train_cli

MINI = dict(backbone_depth=10, bev_h=16, bev_w=16, encoder_layers=2, decoder_layers=2)
OPTIONS = [f"{k}={v}" for k, v in MINI.items()] + ["data.raw_size=(96,160)"]


def _trainer(cfg, weights_seed, seed):
    return Trainer(build_model(cfg, init_state_dict(cfg, seed=weights_seed), "cpu"),
                   total_steps=20, seed=seed)


@pytest.fixture
def one_thread():
    """Bitwise runs: PyTorch's multithreaded CPU backward sums in an order
    that varies from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_resume_equals_an_uninterrupted_run(tmp_path, one_thread):
    cfg = get_config("bevformer_base", **MINI,
                     data=DataConfig(raw_size=(96, 160), queue_length=2))
    assert cfg.use_grid_mask and cfg.ffn_dropout > 0
    batches = [train_batch(cfg, seed=s, device="cpu") for s in range(3)]
    k = 2

    whole = _trainer(cfg, 0, 0)
    ref = [whole.step(b) for b in batches]

    first = _trainer(cfg, 0, 0)
    for b in batches[:k]:
        first.step(b)
    path = str(tmp_path / "ckpts" / f"iter_{k}.pth")
    save_checkpoint(path, first, k, 0)
    del first
    resumed = _trainer(cfg, 1, 5)  # other weights and generators, all overwritten
    step, meta = restore_checkpoint(path, resumed)
    assert step == k and meta == dict(epoch=0, iter=k, config=cfg.name)
    outs = [resumed.step(b) for b in batches[k:]]

    assert outs == ref[k:]
    ours, theirs = resumed.state_dict(), whole.state_dict()
    for key in ("state_dict", "rng"):
        for name, v in theirs[key].items():
            assert torch.equal(ours[key][name], v), (key, name)
    for i, st in theirs["optimizer"]["state"].items():
        for name, v in st.items():
            assert torch.equal(ours["optimizer"]["state"][i][name], v), (i, name)
    assert ours["scheduler"] == theirs["scheduler"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_clis_create_train_resume_test(tmp_path, capsys):
    data, work = str(tmp_path / "data"), str(tmp_path / "work")
    create_data.main(["synth", "--out-dir", data, "--scenes", "2", "--frames", "3",
                      "--img-w", "160", "--img-h", "96"])
    assert len(os.listdir(os.path.join(data, "samples"))) == 2 * 3 * 6
    common = ["bevformer_base", "--data-root", data, "--device", "cpu", "--cfg-options", *OPTIONS]

    done = train_cli.main([*common, "--work-dir", work, "--max-iters", "2", "--log-interval", "1"])
    assert done["steps"] == 2
    ckpt = os.path.join(work, "ckpts", "iter_2.pth")
    assert sorted(torch.load(ckpt, weights_only=True)) == [
        "meta", "optimizer", "rng", "scheduler", "state_dict", "step"]
    done = train_cli.main([*common, "--work-dir", work, "--max-iters", "3", "--log-interval", "1",
                           "--resume-from", ckpt, "--eval-interval-epochs", "1"])
    assert done["steps"] == 1
    resumed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"resumed_from"')]
    assert len(resumed) == 1 and resumed[0]["step"] == 2
    log = _records(os.path.join(work, "train_log.jsonl"))
    assert [r["step"] for r in log] == [0, 1, 2]
    for r in log:
        assert r["host_ms"] > 0 and r["data_wait_ms"] >= 0 and math.isfinite(r["total"])
    # the epoch (3 train frames) ended at step 3: one checkpoint for both
    # reasons, and the in-training evaluation
    assert sorted(os.listdir(os.path.join(work, "ckpts"))) == ["iter_2.pth", "iter_3.pth"]
    (entry,) = _records(os.path.join(work, "eval_log.jsonl"))
    assert entry["step"] == 3 and math.isfinite(entry["NDS"]) and math.isfinite(entry["mAP"])
    last = os.path.join(work, "ckpts", "iter_3.pth")
    done = train_cli.main([*common, "--work-dir", str(tmp_path / "warm"), "--max-iters", "1",
                           "--load-from", last])
    assert done["steps"] == 1 and math.isfinite(done["last"]["total"])

    out = os.path.join(work, "results.json")
    res = test_cli.main([*common, "--checkpoint", last, "--out", out])
    assert res["timing"]["frames"] == 3
    with open(os.path.join(work, "metrics_summary.json")) as f:
        metrics = json.load(f)
    assert sorted(metrics) == ["label_aps", "label_tp_errors", "mean_ap", "nd_score", "tp_errors"]
    assert res["NDS"] == metrics["nd_score"] and res["mAP"] == metrics["mean_ap"]
    assert sorted(res) == sorted(["NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE", "timing"])
    assert os.path.exists(os.path.join(work, "results_nusc.json"))
    with open(out) as f:
        assert [r["token"] for r in json.load(f)] == [f"scene_0001_f00{i}" for i in range(3)]

    only = str(tmp_path / "only.json")
    assert test_cli.main([*common, "--checkpoint", last, "--out", only, "--format-only"]) is None
    with open(str(tmp_path / "only_nusc.json")) as f:
        sub = json.load(f)
    assert sorted(sub) == ["meta", "results"] and len(sub["results"]) == 3
    res = test_cli.main([*common, "--checkpoint", last, "--overlap-test", "--max-samples", "2",
                         "--out", str(tmp_path / "overlap.json")])
    assert res["timing"]["frames"] == 2 and math.isfinite(res["NDS"])


def test_prefetcher_order_errors_and_close():
    cpu = torch.device("cpu")
    prefetch = train_cli.BatchPrefetcher(lambda s: (torch.full((2,), float(s)),), 3, 8, cpu)
    got = [prefetch.get() for _ in range(5)]
    assert [float(b[0][0]) for b, _, _ in got] == [3, 4, 5, 6, 7]
    assert all(host >= 0 and wait >= 0 for _, host, wait in got)
    prefetch.close()
    assert not prefetch._thread.is_alive()

    def failing(step):
        if step == 1:
            raise ValueError("bad sample")
        return (torch.zeros(1),)

    prefetch = train_cli.BatchPrefetcher(failing, 0, 5, cpu)
    prefetch.get()
    with pytest.raises(ValueError, match="bad sample"):
        prefetch.get()
    prefetch.close()
    # closed while its thread waits on a full queue
    prefetch = train_cli.BatchPrefetcher(lambda s: (torch.zeros(1),), 0, 10**6, cpu, depth=1)
    prefetch.get()
    prefetch.close()
    assert not prefetch._thread.is_alive()


@pytest.mark.parametrize("cli", [train_cli, test_cli], ids=["train", "test"])
def test_clis_default_to_the_card(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bevformer_base", "--data-root", str(tmp_path)])
