"""Print a resolved config as JSON: the JAX package's
`tools/misc/print_config.py` on the port's configs.

    python3 -m bevformer_torch.tools.misc.print_config <config> [--cfg-options key=val ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

from bevformer_torch.configs import apply_overrides, get_config


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="print a resolved config")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = get_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.cfg_options))
    out = dataclasses.asdict(cfg)
    print(json.dumps(out, indent=2, default=str))
    return out


if __name__ == "__main__":
    main()
