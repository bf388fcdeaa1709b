"""The readings that a cell's limits are set from, in one process.

    python3 bench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9

For each program seed: the cell's set-up at its own size, as many tests
through the timed entry as a run compares (the check file's `sample`),
each compared with the float64 reference (f_gap, p_out). For each control
seed: the reference computed in TF32 (every product operand rounded to
TF32, float32 elsewhere) put in the program's place, compared the same
way. One JSON line per seed, then the largest program reading and the
smallest control reading. Not run by the benchmark's own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import run as _run  # noqa: E402


def readings(c, seed: int, device, control: bool, sizes=None) -> dict:
    from bench import harness
    wl = harness.Workload(c, seed, device, sizes)
    inputs = wl.make_inputs()
    k = int(c.check["sample"])
    lim = float(c.check["f_gap"])
    if not control:
        outs = {i: wl.call(inputs, wl.test(i)) for i in range(k)}
        return harness.check(wl, inputs, outs, list(range(k)))
    worst = {"f_gap": 0.0, "p_out": 0.0}
    d2 = harness.squared(wl, inputs)
    d2_low = harness.squared(wl, inputs, "tf32")
    for i in range(k):
        t = wl.test(i)
        low = harness.reference_nulls(t, d2_low, "tf32")
        got = harness.compare(low, harness.reference_nulls(t, d2), lim)
        worst = {key: max(worst[key], got[key]) for key in worst}
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    _run.environment()
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(args.workload)
    lows, highs = [], []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            t = time.perf_counter()
            got = readings(c, s, "cuda", control)
            (highs if control else lows).append(got["f_gap"])
            print(json.dumps({"cell": c.name, "seed": s, "control": control,
                              **got, "s": time.perf_counter() - t}),
                  flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"cell": c.name, "program_max_f_gap": max(lows or [0]),
                      "control_min_f_gap": min(highs or [0]),
                      "power_limit": harness.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
