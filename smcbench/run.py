"""Run one cell of the benchmark on the card this machine holds.

    python3 smcbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the check compared, with its limit); the last
lines of standard error repeat the checks. With no card, too few cards,
or JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: kernel caches, at fixed paths inside the checkout (git-ignored)
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "_build" / "smcbench" / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    from smcbench.harness.spec import Cell
    from smcbench.harness.runner import (execute, device_facts,
                                         forbidden_modules)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"smcbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"smcbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    result["device"] = {**device_facts(), **result["device"]}
    print(f"smcbench: {_power_limit()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
