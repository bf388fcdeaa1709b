"""Time the dense bridge's PCoA (eigh of the Gower matrix) at the EMP shape.

    python3 scripts/pcoa_eigh_probe.py [--n 25145] [--k 3]

The dense bridge's ordination eigendecomposes the whole (n, n) Gower
matrix (pipeline.ordination.pcoa_eigh: one torch.linalg.eigh, cuSOLVER in
f32). At the EMP shape that call takes far longer than the test itself,
so chip_smoke.py does not run it every time; this script times it once.
It builds the Bray-Curtis matrix of synthetic_study(n, 128, 8, effect 1.0,
seed 0) with the distance kernel, times pcoa_eigh and, on the same
matrix, pcoa_subspace (the stream bridge's implicit operator), and
prints both times, the eigenvalues and the subspace path's error against
eigh (sign-aligned, over the scale, as the reference's test bars it),
with the card's name and power limit first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=25145)
    ap.add_argument("--k", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pcoa_eigh_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import distance
    from repro_torch.data.microbiome import synthetic_study
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.pipeline import ordination as ordn
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    x, _ = synthetic_study(args.n, 128, 8, effect_size=1.0, seed=0)
    xp = distance.ROW_METRICS["braycurtis"].prepare(
        torch.from_numpy(x).to(dev))
    dm = dops.pairwise_distance(xp, metric="braycurtis")
    mat2 = dm * dm
    del dm
    out = {}
    for tag, fn in (("subspace", ordn.pcoa_subspace),
                    ("eigh", ordn.pcoa_eigh)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(mat2, args.k)
        res.coords.sum().item()                                    # waits
        out[tag] = (time.perf_counter() - t0, res)
        print(f"[probe] pcoa_{tag} n={args.n} k={args.k}: "
              f"{out[tag][0]:.3f}s, eigenvalues "
              f"{[round(float(v), 4) for v in res.eigvals]}, iterations "
              f"{res.iterations}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    e, s = out["eigh"][1], out["subspace"][1]
    ref = e.coords.double()
    c = s.coords.double()
    sgn = torch.sign((c * ref).sum(0))
    sgn[sgn == 0] = 1.0
    wk = e.eigvals.double()
    print(f"[probe] subspace vs eigh: eigenvalues "
          f"{float(((s.eigvals.double() - wk).abs() / wk.abs().max()).max()):.3e}"
          f", coords {float(((c * sgn - ref).abs() / ref.abs().max()).max()):.3e}"
          " of scale")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
