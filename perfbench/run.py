"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic, driver,
limits and metrics are found by the names in ``BENCHMARK.json``
(``core.py``).  The run needs the card: without CUDA, or with fewer cards
than the cell asks for, it exits with an error and prints no result.  It
also prints no result, and fails, if JAX or the JAX package
(``resampler_tpu``) was loaded.  The numbers compared, each with its limit,
close standard error and sit last in the result's line.
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
CACHE = ROOT / ".perfbench_cache"


def card_note() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the control (the reference in TF32) in the program's place: its outputs "
                         "are judged instead of the program's, and the run must read correct false")
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench import core

    bench = core.load_benchmark(ROOT)
    cell = core.find_cell(bench, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False; this benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {cell.name} needs {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2

    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                           T_START, control=bool(args.control))
    found = core.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card_note()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
