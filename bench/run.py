"""Run one cell of BENCHMARK.json once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output, and the compared numbers beside their limits as the last
lines of standard error. Exits non-zero, with no result, without as many
CUDA cards as the cell asks for, or if jax, jaxlib, flax or the JAX
package `repro` was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment() -> None:
    """Caches at fixed paths inside the checkout; no autotune file, so a
    plan cannot depend on a file under HOME."""
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = "off"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    import torch
    from bench import harness
    c = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"needs {c.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(c, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
