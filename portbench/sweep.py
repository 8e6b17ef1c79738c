"""Runs of one cell one after another, each a process of its own as the
benchmark's check runs them, and the spread of each metric.

    python3 -m portbench.sweep --workload <cell> --seeds <n> ... [--seconds s]
        [--trace 0|1] [--out <file>.jsonl]

For each seed it runs `python3 -m portbench.run`, keeps the last line of
its output (with the seed and the exit code) and prints it; then, per
metric, the median and the spread: the distance between the first and the
third quartile (`statistics.quantiles(values, n=4)`) over the median, the
first run left out where there are four or more (it compiles in a fresh
checkout).
"""

import argparse
import json
import statistics
import subprocess
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="runs of one cell and their spread")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        cmd = [sys.executable, "-m", "portbench.run", "--workload", args.workload, "--seed",
               str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "{}"
        try:
            row = json.loads(last)
        except json.JSONDecodeError:
            row = {}
        row.update(seed=seed, rc=p.returncode, workload=args.workload, trace=args.trace)
        if p.returncode:
            row["stderr"] = p.stderr[-3000:]
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    metrics = sorted({k for r in rows for k in r.get("metrics", {})})
    for name in metrics:
        vals = [r["metrics"][name]["value"] for r in rows if name in r.get("metrics", {})]
        steady = vals[1:] if len(vals) >= 4 else vals
        line = dict(metric=name, median=statistics.median(steady), values=vals)
        if len(steady) >= 2:
            line["spread"] = spread(steady)
        print(json.dumps(line), flush=True)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
