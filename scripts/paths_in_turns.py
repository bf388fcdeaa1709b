"""Time the port's features paths from two checkouts in turns, on one card.

    python3 scripts/paths_in_turns.py OTHER_DIR [--rounds 1]

OTHER_DIR is another checkout of the repo (for example the parent commit,
unpacked with `git archive` into an ignored directory). Each round runs
OTHER, THIS, THIS, OTHER, one process a turn, each on its own tree's
`src/` (so each builds its own kernels). A turn runs pipeline() at the EMP
shape with the default budgets (n = 25,145 synthetic samples, 128
features, 8 groups, 3,999 permutations, seed 0) for plain labels, labels
within 4 strata and the K = 10 covariate design: one warm-up, then the
best of three end-to-end times, with the fused kernels' launches and the
device peak above the start. It prints the card's name and power limit
first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N, D, GROUPS, PERMS = 25145, 128, 8, 3999


def turn() -> dict:
    """One turn, in the tree on sys.path: each path's times and counts."""
    import torch
    from repro_torch import pipeline
    from repro_torch.data.microbiome import synthetic_design, synthetic_study
    from repro_torch.kernels.fused_sw import ops as fops
    dev = torch.device("cuda:0")
    x, g = synthetic_study(N, D, GROUPS, effect_size=1.0, seed=0)
    cov, strata, _ = synthetic_design(N, covariate_names=("age", "depth"),
                                      n_strata=4, seed=0)
    x, g = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
    paths = {"labels": {}, "strata": dict(strata=strata),
             "covariates": dict(covariates=cov)}
    out = {}
    for tag, kw in paths.items():
        def run():
            res = pipeline.pipeline(x, g, metric="braycurtis",
                                    n_perms=PERMS, seed=0, device=dev, **kw)
            return float(res.f_stat), float(res.p_value)
        run()                                   # builds the kernels
        times = []
        for _ in range(3):
            for k in fops.LAUNCHES:
                fops.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            f_p = run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() - start
        out[tag] = {"s": min(times), "times": times, "f_p": f_p,
                    "launches": {k: v for k, v in fops.LAUNCHES.items()
                                 if v},
                    "peak_mib": peak / 2 ** 20}
    return out


def in_turns(script: str, other: str, rounds: int):
    """Run `script --turn` from OTHER and THIS tree in turns (OTHER, THIS,
    THIS, OTHER a round), each on its own tree's `src/`, after printing
    the card's name and power limit: yields (round, tree name, the
    turn's JSON result); raises if a turn fails."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"other": os.path.abspath(other), "this": here}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for r in range(rounds):
        for name in ("other", "this", "this", "other"):
            tree = trees[name]
            env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
            done = subprocess.run(
                [sys.executable, os.path.abspath(script), "--turn"],
                cwd=tree, env=env, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"turn {name} failed:\n{done.stderr}")
            yield r, name, json.loads(done.stdout.strip().splitlines()[-1])


def parse_args(doc: str):
    """OTHER_DIR, --rounds and the hidden --turn of an in-turns script."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--turn", action="store_true",
                    help=argparse.SUPPRESS)     # one turn, JSON on stdout
    args = ap.parse_args()
    if not args.turn and not args.other:
        ap.error("OTHER_DIR is required")
    return args


def main() -> int:
    args = parse_args(__doc__)
    if args.turn:
        print(json.dumps(turn()))
        return 0
    for r, name, res in in_turns(__file__, args.other, args.rounds):
        for tag, v in res.items():
            print(f"round {r} {name:5s} {tag:10s} best {v['s']:.4f} s "
                  f"(of {', '.join(f'{t:.4f}' for t in v['times'])}) "
                  f"F, p {v['f_p']} launches {v['launches']} peak "
                  f"{v['peak_mib']:.2f} MiB", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
