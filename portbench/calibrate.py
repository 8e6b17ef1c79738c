"""The readings a cell's limits are set from: for each seed, one run of
the cell (set-up, a short window at the cell's own load, the check), the
program's numbers and those of the control, the reference computed in
TF32 in the program's place, from the same inputs. With `--fault`, the
program runs with that fault planted in its timed path (`stale`: a step
hands back the state it was given; `alter`: an answer altered where it is
produced; training: `dx`, `dw`, the DCN layers' input or weight gradient
doubled where it is made).

    python3 -m portbench.calibrate --workload <cell> --seconds <s> --seeds <n> ...
        [--fault stale|alter|dx|dw] [--control 0|1] [--out <file>.jsonl]

One JSON line a seed on standard output (and appended to `--out`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("stale", "alter", "dx", "dw"))
    ap.add_argument("--control", type=int, choices=(0, 1), default=1,
                    help="with no fault, also read the control (default 1)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, device, t0, fault=args.fault,
                          control=args.fault is None and bool(args.control),
                          log=lambda m: print(f"calibrate: {m}", file=sys.stderr, flush=True))
        line = json.dumps(dict(workload=cell.name, seed=seed, fault=args.fault,
                               program={k: v["value"] for k, v in out["checks"].items()},
                               control=out.get("control"), details=out.get("details"),
                               control_details=out.get("control_details"),
                               seconds=time.perf_counter() - t0))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
