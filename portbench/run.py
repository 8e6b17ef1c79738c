"""The benchmark's entry: one run of one cell on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up the cell (weights and inputs made
on the card from the seed, the cell's shapes warmed up, the kernels built
into `bevformer_torch/build/` on a checkout's first run), measures for
`--seconds`, with `--trace 1` then profiles a few frames or steps, checks
what the window produced against the plain reference, and prints the
checks on standard error and one JSON line on standard output: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks` (each number compared, with its limit). Without a card,
with fewer cards than the cell asks for, or when the process holds a
module of JAX or of the JAX package after the window, it prints no result
and exits with another code than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every compile cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / ".cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".cache" / "triton")

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                         log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"the process holds {', '.join(found)}: the port may not load JAX")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
