"""PERMANOVA launcher — the paper's workload as a CLI, on the port.

Twin of `repro/launch/permanova.py` for the matrix and features paths:
a synthetic study, its distance matrix, then the full test through the
engine; or, with --from-features, the whole features->p-value pipeline
under one joint plan (distance kernel, bridge, s_W).

  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 512 --features 128 --groups 8 --perms 999 --impl auto

  # the paper's EMP shape on the card (2 streamed label chunks):
  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999

  # features -> p-value; at the default budgets the planner picks the
  # fused-kernel bridge there (one megakernel launch per label chunk, no
  # (n, n) array); --materialize stream squares D row slabs into one buffer:
  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999 --from-features

  # the fused kernel's feature modes: bf16, fp8 (e4m3 + per-study scale)
  # or, for jaccard, packed presence words (F and p equal to f32's):
  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999 --feat-precision fp8

  # a design: covariates (adjusted for, sequential terms), permutations
  # within strata, sample weights; prints a per-term F / R2 / p table:
  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999 --from-features \
      --covariates age,depth --strata site:4 --weights

  # out of core: the table in a slab cache under DIR (built from the
  # synthetic study on first use, opened after that); below the device
  # budget's residency the sweep streams slabs from disk through the
  # prefetcher into the fused bridge's sweep, one distance launch a
  # (row slab, column slab) pair:
  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 25145 --features 16384 --perms 999 \
      --features-cache /path/to/cache --slab-rows 2048 \
      --device-budget-mb 1536

  # measured instead of heuristic picks (winners persist in
  # $REPRO_TORCH_AUTOTUNE_CACHE, default ~/.cache/repro_torch/autotune.json),
  # and the top-3 PCoA axes from the same dataflow:
  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999 --autotune --pcoa 3

  # telemetry: spans of every layer as Chrome/Perfetto trace_event JSON,
  # and the predicted-vs-measured report with the counters:
  PYTHONPATH=src python -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999 --from-features \
      --trace /tmp/permanova.json --metrics

  # several cards: every rank runs the same command under torchrun.
  # --distributed shards the matrix path over (data = world, model = 1)
  # (permutations; core.permanova_distributed); --shard-rows N runs the
  # fused-kernel sweep over (data = world / N, model = N) (rows over
  # 'model', permutations over 'data'). Rank 0 prints the result lines:
  torchrun --standalone --nproc-per-node=4 -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999 --distributed
  torchrun --standalone --nproc-per-node=4 -m repro_torch.launch.permanova \
      --samples 25145 --perms 3999 --shard-rows 2

Runs on the card (`--device cuda`, the default) and fails without one;
`--device cpu` runs the plain PyTorch forms on the host (a gloo world
under --distributed / --shard-rows; without torchrun those run as a world
of one).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch

from repro_torch import engine, obs, pipeline
from repro_torch.core.distance import (distance_matrix,
                                       validate_distance_matrix)
from repro_torch.data import slabcache
from repro_torch.data.microbiome import synthetic_design, synthetic_study
from repro_torch.pipeline import planner as _pplanner
from repro_torch.hw import resolve_device

IMPL_CHOICES = ["auto", "brute", "tiled", "matmul",
                "pallas_brute", "pallas_permblock", "pallas_matmul"]
# the reference's legacy --kernel: its kernel family's name for each impl
KERNEL_IMPLS = {"auto": "pallas_matmul", "brute": "pallas_brute",
                "tiled": "pallas_permblock", "matmul": "pallas_matmul"}


def _emit_obs(args):
    """Export the trace and/or print the telemetry report, if asked."""
    if args.trace:
        obs.trace.export(args.trace)
        print(f"[permanova] trace written to {args.trace} "
              f"({len(obs.events())} events)")
    if args.metrics:
        obs.report(file=sys.stdout)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _world(dev: torch.device):
    """The process group of a torchrun launch (env://), or a world of one
    without one; torn down after the run. NCCL on the card, gloo on the
    CPU. Yields the rank."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as _mesh
    if "WORLD_SIZE" not in os.environ:
        with _mesh.world_of_one(dev):
            yield 0
        return
    _mesh.init_distributed(dev)
    try:
        yield dist.get_rank()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--features", type=int, default=128)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--perms", type=int, default=999)
    ap.add_argument("--effect", type=float, default=1.0)
    ap.add_argument("--metric", default="braycurtis",
                    choices=["braycurtis", "euclidean", "jaccard",
                             "aitchison"])
    ap.add_argument("--impl", default="auto", choices=IMPL_CHOICES,
                    help="'auto' = planner (GPU-brute / CPU-tiled per the "
                         "paper); or pin a registry impl")
    ap.add_argument("--autotune", action="store_true",
                    help="empirically measure candidates on the real "
                         "operands instead of trusting the heuristics "
                         "(the winners persist for later runs)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="label-tensor memory budget; sweeps beyond it "
                         "stream in fixed-size chunks")
    ap.add_argument("--chunk", type=int, default=None,
                    help="pin the streaming chunk (perms per dispatch)")
    ap.add_argument("--from-features", action="store_true",
                    help="route through the pipeline: distance "
                         "construction + s_W planned jointly (stage-1 "
                         "impl, bridge, chunking in one plan)")
    ap.add_argument("--materialize", default="auto",
                    choices=["auto", "dense", "stream", "fused",
                             "fused-kernel"],
                    help="pipeline bridge: materialize D, stream D^2 row "
                         "blocks into one buffer, fuse blocks straight "
                         "into the permutation sweep, or run the single-"
                         "pass fused-kernel (distance tiles contracted "
                         "in-kernel; D^2 never resident); implies "
                         "--from-features")
    ap.add_argument("--fused-impl", default="auto",
                    choices=["auto", "cuda", "torch", "pallas", "xla"],
                    help="fused-kernel implementation: the CUDA megakernel "
                         "(alias pallas; its plain version on --device "
                         "cpu) or the plain torch sweep (alias xla)")
    ap.add_argument("--feat-precision", default="f32",
                    choices=list(pipeline.registry.PRECISIONS),
                    help="feature storage for the fused-kernel sweep: f32, "
                         "bf16, fp8 (e4m3 + per-metric scale, f32 sums), or "
                         "packed (jaccard only: presence bits in 32-bit "
                         "words, popcount tiles; the same F and p as f32); "
                         "implies --materialize fused-kernel when not f32")
    ap.add_argument("--shard-rows", type=int, default=None, metavar="N",
                    help="run the fused-kernel sweep over an N-way 'model' "
                         "mesh axis (row slabs sharded, the ranks' partials "
                         "all-gathered and summed in rank order; the other "
                         "ranks shard permutations); implies --materialize "
                         "fused-kernel; every rank of a torchrun launch "
                         "runs it")
    ap.add_argument("--kernel", action="store_true",
                    help="legacy alias, as in the reference: --impl auto "
                         "or matmul -> pallas_matmul, brute -> "
                         "pallas_brute, tiled -> pallas_permblock (ignored "
                         "for a pallas_* --impl); on the port those names "
                         "are aliases of matmul, brute and tiled, each its "
                         "CUDA kernel on the card and its plain version "
                         "on --device cpu")
    ap.add_argument("--distributed", action="store_true",
                    help="shard the matrix path's permutations over every "
                         "rank of the torchrun launch "
                         "(core.permanova_distributed)")
    ap.add_argument("--dist-impl", default="auto",
                    help="pin the stage-1 distance impl (e.g. "
                         "'braycurtis.cuda', 'euclidean.blocked'); "
                         "'auto' = pipeline planner; implies "
                         "--from-features")
    ap.add_argument("--features-cache", default=None, metavar="DIR",
                    help="run from a disk slab cache at DIR (built from "
                         "the synthetic study on first use, opened after "
                         "that): below the device budget's residency the "
                         "table never lives in memory whole, its slabs "
                         "stream through the prefetcher into the fused "
                         "sweep; implies the pipeline path")
    ap.add_argument("--cache-format", default="dense",
                    choices=list(slabcache.FORMATS),
                    help="slab-cache storage when building --features-"
                         "cache: raw f32 rows, or csr presence structure "
                         "(jaccard only: reads nonzeros, not zeros)")
    ap.add_argument("--slab-rows", type=int, default=None, metavar="R",
                    help="slab height when building --features-cache "
                         "(default: the planner's plan_slab_rows for the "
                         "device budget)")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="device-memory budget grading the feature "
                         "residency tier (hbm / host / disk) of "
                         "--features-cache runs; below the table's f32 "
                         "size the sweep runs out of core")
    ap.add_argument("--pcoa", type=int, default=None, metavar="K",
                    help="also compute the top-K PCoA ordination axes "
                         "(coordinates + explained variance) from the "
                         "same pipeline dataflow (the stream and fused "
                         "bridges never build the Gower matrix); implies "
                         "the pipeline path")
    ap.add_argument("--covariates", default=None, metavar="NAMES",
                    help="comma-separated covariate names (synthetic "
                         "standard-normal columns, e.g. 'age,depth'): the "
                         "covariate design path, sequential adonis2-style "
                         "terms with the grouping factor last (adjusted "
                         "for the covariates); prints a per-term F/R2/p "
                         "table; implies --from-features")
    ap.add_argument("--strata", default=None, metavar="NAME[:K]",
                    help="restrict permutations within K synthetic blocks "
                         "(default K=4), e.g. 'site' or 'site:6' (vegan's "
                         "strata=); implies --from-features")
    ap.add_argument("--weights", action="store_true",
                    help="weighted PERMANOVA: synthetic positive sample "
                         "weights folded into the design basis; implies "
                         "--from-features")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record trace spans across every layer and write "
                         "Chrome/Perfetto trace_event JSON to PATH (open "
                         "in chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the telemetry report after the run: the "
                         "per-stage predicted-vs-measured bandwidth table "
                         "and the build, launch and traffic counters")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.trace or args.metrics:
        obs.enable(trace=bool(args.trace) or args.metrics, metrics=True)
    if args.kernel and not args.impl.startswith("pallas_"):
        args.impl = KERNEL_IMPLS[args.impl]

    dev = resolve_device(args.device)
    x, grouping = synthetic_study(args.samples, args.features, args.groups,
                                  effect_size=args.effect, seed=args.seed)
    budget = None if args.budget_mb is None else args.budget_mb * 2**20

    covariates = strata = weights = None
    design_path = (args.covariates is not None or args.strata is not None
                   or args.weights)
    if design_path:
        cov_names = (tuple(c for c in args.covariates.split(",") if c)
                     if args.covariates else ())
        n_strata = 0
        if args.strata is not None:
            _, _, k = args.strata.partition(":")
            n_strata = int(k) if k else 4
        covariates, strata, weights = synthetic_design(
            args.samples, covariate_names=cov_names, n_strata=n_strata,
            weighted=args.weights, seed=args.seed)

    fused_tuning = None
    if args.feat_precision != "f32":
        # the precision knobs live on the fused-kernel sweep; route there
        if args.materialize not in ("auto", "fused-kernel"):
            ap.error("--feat-precision applies to the fused-kernel sweep; "
                     "drop --materialize or set it to fused-kernel")
        args.materialize = "fused-kernel"
        fused_tuning = pipeline.registry.precision_tuning(
            args.feat_precision)

    features = torch.from_numpy(x)
    dev_budget = (None if args.device_budget_mb is None
                  else args.device_budget_mb * 2**20)
    if args.features_cache is not None:
        if os.path.exists(os.path.join(args.features_cache,
                                       slabcache.META_NAME)):
            features = slabcache.SlabCache.open(args.features_cache)
            print(f"[permanova] opened slab cache {args.features_cache}: "
                  f"{features.n_slabs} slabs x {features.slab_rows} rows "
                  f"({features.fmt})")
        else:
            rows = args.slab_rows or _pplanner.plan_slab_rows(
                args.samples, args.features, device_budget_bytes=dev_budget)
            features = slabcache.build_slab_cache(
                args.features_cache, x, slab_rows=rows,
                fmt=args.cache_format)
            print(f"[permanova] built slab cache {args.features_cache}: "
                  f"{features.n_slabs} slabs x {features.slab_rows} rows, "
                  f"{features.disk_bytes/2**20:.1f} MiB on disk "
                  f"({args.cache_format})")

    if args.from_features or args.materialize != "auto" \
            or args.dist_impl != "auto" or args.fused_impl != "auto" \
            or args.shard_rows is not None \
            or args.pcoa is not None or design_path \
            or args.features_cache is not None:
        if args.distributed:
            ap.error("--distributed is not supported with the pipeline "
                     "path (--from-features/--materialize/--dist-impl); "
                     "use --shard-rows for the fused-kernel mesh, or "
                     "precompute the matrix and drop --distributed")
        sharded = args.shard_rows is not None
        if sharded and args.materialize not in ("auto", "fused-kernel"):
            ap.error("--shard-rows runs the fused-kernel sweep; drop "
                     "--materialize or set it to fused-kernel")
        if sharded and args.shard_rows < 1:
            ap.error("--shard-rows takes a positive number of row shards")
        with (_world(dev) if sharded else contextlib.nullcontext(0)) as rank:
            mesh = None
            if sharded:
                from repro_torch.launch import mesh as _mesh
                mesh = _mesh.make_host_mesh(model_ways=args.shard_rows,
                                            device_type=dev.type)
                dev = _mesh.mesh_device(mesh)
            return _pipeline_run(args, features, grouping, budget,
                                 fused_tuning, covariates, strata, weights,
                                 dev_budget, dev, mesh=mesh,
                                 quiet=rank != 0)

    with (_world(dev) if args.distributed
          else contextlib.nullcontext(0)) as rank:
        mesh = None
        if args.distributed:
            from repro_torch.launch import mesh as _mesh
            mesh = _mesh.make_host_mesh(device_type=dev.type)
            dev = _mesh.mesh_device(mesh)
        t0 = time.perf_counter()
        dm = distance_matrix(torch.from_numpy(x).to(dev), args.metric)
        checks = validate_distance_matrix(dm)
        if not checks["ok"]:
            raise RuntimeError(f"distance matrix failed its checks: "
                               f"{checks}")
        _sync(dev)
        t_dm = time.perf_counter() - t0

        t0 = time.perf_counter()
        if mesh is None:
            res = engine.run(dm, torch.from_numpy(grouping),
                             n_perms=args.perms, seed=args.seed,
                             impl=args.impl, memory_budget_bytes=budget,
                             chunk=args.chunk, autotune=args.autotune,
                             device=dev)
        else:
            from repro_torch.core import permanova_distributed
            res = permanova_distributed(
                mesh, dm, torch.from_numpy(grouping), n_perms=args.perms,
                seed=args.seed, impl=args.impl, chunk=args.chunk,
                memory_budget_bytes=budget)
        f_stat, p_value = float(res.f_stat), float(res.p_value)   # waits
        t_pa = time.perf_counter() - t0
        if rank == 0:
            _print_matrix_run(args, res, dev, t_dm, t_pa, f_stat, p_value,
                              " +distributed" if mesh is not None else "")
    return 0


def _print_matrix_run(args, res, dev, t_dm, t_pa, f_stat, p_value,
                      tag=""):
    print(f"[permanova] n={args.samples} groups={args.groups} "
          f"perms={res.n_perms} metric={args.metric} impl={args.impl}"
          f"{tag} device={dev}")
    print(f"[permanova] plan: {res.plan}")
    print(f"[permanova] distance-matrix {t_dm:.2f}s  "
          f"permutation-test {t_pa:.2f}s "
          f"({res.n_perms / t_pa:.1f} perms/s)")
    print(f"[permanova] F={f_stat:.6g} p={p_value:.6g}")
    _emit_obs(args)


def _pipeline_run(args, features, grouping, budget, fused_tuning,
                  covariates, strata, weights, dev_budget, dev, *,
                  mesh=None, quiet=False) -> int:
    """The features -> p-value path (over `mesh` with --shard-rows); the
    result lines unless `quiet` (the ranks other than 0)."""
    t0 = time.perf_counter()
    res = pipeline.pipeline(
        features, torch.from_numpy(grouping),
        metric=args.metric, n_perms=args.perms, seed=args.seed,
        dist_impl=args.dist_impl, sw_impl=args.impl,
        materialize=args.materialize, chunk=args.chunk,
        fused_impl=args.fused_impl, fused_tuning=fused_tuning,
        memory_budget_bytes=budget, ordination=args.pcoa,
        covariates=covariates, strata=strata, weights=weights,
        autotune=args.autotune, device_budget_bytes=dev_budget,
        mesh=mesh, device=dev)
    f_stat, p_value = float(res.f_stat), float(res.p_value)   # waits
    t_pa = time.perf_counter() - t0
    if quiet:
        return 0
    print(f"[permanova] n={args.samples} groups={args.groups} "
          f"perms={res.n_perms} metric={args.metric} pipeline "
          f"device={dev}")
    print(f"[permanova] plan: {res.plan}")
    print(f"[permanova] features->p-value {t_pa:.2f}s "
          f"({res.n_perms / t_pa:.1f} perms/s)")
    print(f"[permanova] F={f_stat:.6g} p={p_value:.6g} "
          f"R2={float(res.r2):.4g}")
    if res.terms is not None:
        print(f"[permanova] {'term':<12} {'df':>3} {'SS':>10} "
              f"{'F':>9} {'R2':>8} {'p':>8}")
        for t in res.terms:
            print(f"[permanova] {t.name:<12} {t.df:>3} "
                  f"{float(t.ss):>10.4g} {float(t.f_stat):>9.4g} "
                  f"{float(t.r2):>8.4g} {float(t.p_value):>8.4g}")
    if res.ordination is not None:
        o = res.ordination
        expl = ", ".join(f"{float(v):.3f}" for v in o.explained)
        print(f"[permanova] pcoa[{o.method}] k={o.k} "
              f"explained=[{expl}] coords={tuple(o.coords.shape)} "
              f"iterations={o.iterations}")
    _emit_obs(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
