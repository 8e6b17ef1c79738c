"""Training-log analysis: the JAX package's
`tools/analysis_tools/analyze_logs.py` over the port's `train_log.jsonl`
(`bevformer_torch.tools.train`: one JSON line per logged step, with
`step`, `time` (seconds since the run's first step) and the losses).

    python3 -m bevformer_torch.tools.analysis_tools.analyze_logs cal_train_time LOG.jsonl
    python3 -m bevformer_torch.tools.analysis_tools.analyze_logs plot_curve LOG.jsonl \
        [--keys total loss_cls] [--out curves.png]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def load_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cal_train_time(entries):
    """Seconds per step between logged entries: slowest, fastest, mean."""
    if len(entries) < 2:
        print("not enough entries")
        return None
    arr = np.array([(b["time"] - a["time"]) / max(b["step"] - a["step"], 1)
                    for a, b in zip(entries[:-1], entries[1:])])
    print(f"slowest iter: {arr.max():.3f}s, fastest: {arr.min():.3f}s, "
          f"mean: {arr.mean():.3f}s/iter")
    return dict(slowest=float(arr.max()), fastest=float(arr.min()), mean=float(arr.mean()))


def plot_curve(entries, keys, out):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = [e["step"] for e in entries]
    fig = plt.figure()
    for k in keys:
        plt.plot(steps, [e.get(k, float("nan")) for e in entries], label=k)
    plt.xlabel("iter")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="analyse a train_log.jsonl")
    p.add_argument("task", choices=["cal_train_time", "plot_curve"])
    p.add_argument("log")
    p.add_argument("--keys", nargs="*", default=["total"])
    p.add_argument("--out", default="curves.png")
    args = p.parse_args(argv)
    entries = load_log(args.log)
    if args.task == "cal_train_time":
        return cal_train_time(entries)
    return plot_curve(entries, args.keys, args.out)


if __name__ == "__main__":
    main()
