"""Multi-pod dry-run: build every (architecture x input-shape) cell on the
production meshes, count one rank's step and record memory / cost /
roofline artifacts (twin of `repro/launch/dryrun.py`).

  single pod : (16, 16)     ("data", "model")          = 256 ranks
  multi-pod  : (2, 16, 16)  ("pod", "data", "model")   = 512 ranks

The reference lowers and compiles each cell for 512 forced host devices.
The port runs the cell's step once on DTensors of fake shards over a
fake process group of 256 or 512 ranks in this one process
(`launch.mesh.fake_world`, `launch.cells`) and counts what rank 0 does
(`roofline.op_cost`): no device, no data, no compute. The terms are
counts against the H100's datasheet peaks (`hw`), not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh both --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

A record ({arch}__{shape}__{mesh}.json) keeps the reference's keys. Its
memory entry is rank 0's peak of live bytes over the step from torch's
`MemTracker` (`memory_source`), in place of XLA's memory analysis; a
cell that raises is recorded as `error` and the run goes on.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import torch

from repro_torch import hw
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, list_archs
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.model import param_specs
from repro_torch.roofline.analysis import analyze_cell, model_flops
from repro_torch.roofline.op_cost import counting, peak_bytes
from repro_torch.sharding.rules import set_active


# local ops a cell may run: ~1.5M at most for every cell (~0.2-0.5 ms a
# DTensor op on one core), sLSTM's time loop counted from four steps a
# layer (`_slstm_counted_once`); past it the cell is recorded as an error
MAX_LOCAL_OPS = 4_000_000


def cell_model_flops(cfg, shape, kind: str) -> float:
    """The reference's MODEL_FLOPS of a cell from the config's spec tree."""
    tokens = (shape.global_batch * shape.seq_len
              if kind in ("train", "prefill") else shape.global_batch)
    specs = param_specs(cfg)
    return model_flops(cfg, specs, _spec_axes(specs), tokens=tokens,
                       kind="train" if kind == "train" else "inference")


def _spec_axes(specs):
    if hasattr(specs, "axes"):
        return specs.axes
    return {k: _spec_axes(v) for k, v in specs.items()}


@contextlib.contextmanager
def _microbatch_counted_once(cost, n_microbatches: int):
    """The train step's microbatches are one program run n times on
    same-shaped slices: the first runs and is counted, each later one
    adds the first's counts and returns its outputs (fake values). The
    reference's hlo_cost multiplies its accumulation scan's body by its
    trip count the same way. The last call hands the outputs over, so
    the first's gradients are freed as the step frees each
    microbatch's."""
    from repro_torch.train import step as train_step

    if n_microbatches <= 1:
        yield
        return
    orig = train_step.value_and_grad
    first = {"calls": 0}

    def once(model, batch):
        first["calls"] += 1
        if first["calls"] == 1:
            before = cost.snapshot()
            first["out"] = orig(model, batch)
            first["delta"] = (before, cost.snapshot())
        else:
            cost.add_since(*first["delta"])
        if first["calls"] == n_microbatches:
            return first.pop("out")
        return first["out"]

    train_step.value_and_grad = once
    try:
        yield
    finally:
        train_step.value_and_grad = orig


SLSTM_WARMUP = 2    # steps run before the one counted for the rest


def _live_bytes(mem) -> int:
    return sum(d.get("Total", 0)
               for d in mem.get_tracker_snapshot("current").values())


@contextlib.contextmanager
def _slstm_counted_once(cost, mem):
    """sLSTM's time loop counted as the reference's scan: one step's
    counts times the trip count. Steps 0 .. SLSTM_WARMUP - 1 and the
    last two run, the state of the warm-up's last handed to step S - 2;
    the k = S - SLSTM_WARMUP - 2 steps between are not run. Step S - 2
    is an inner step, warm state in and a step after it: its forward's
    counts are added k times, and so are its backward's. Autograd runs
    a node only after every node made later in the forward, and a
    step's h is its last op, so the backward of step t starts with the
    node of h_t: step S - 2's backward spans from that node's pre-hook
    to the warm-up's last h's. Each step's h stays live for the stack
    and, in training, its saved tensors for the backward: k times step
    S - 2's growth of live bytes is held as one fake buffer while the
    loop's outputs are (prefill) or until the skipped steps' backward
    would have freed them (training). The stack reads S tensors of h's
    shape, the skipped ones a detached h that takes no gradient."""
    from repro_torch.models import xlstm

    orig = xlstm.slstm_forward

    def forward(params, cfg, x, *, state=None):
        b, s, d = x.shape
        k = s - SLSTM_WARMUP - 2
        if k < 1:
            return orig(params, cfg, x, state=state)
        if state is None:
            state = {key: torch.zeros((b, d), dtype=torch.float32,
                                      device=x.device)
                     for key in ("c", "n", "h", "m")}

        def step(t, state):
            return xlstm._slstm_cell(params, cfg, x[:, t], state)

        hs = []
        for t in range(SLSTM_WARMUP):
            state = step(t, state)
            hs.append(state["h"])
        before, live = cost.snapshot(), _live_bytes(mem)
        state = step(s - 2, state)
        cost.add_since(before, cost.snapshot(), k)
        grown = _live_bytes(mem) - live
        counts = cost.snapshot()
        held = [torch.empty((k * grown,), dtype=torch.uint8,
                            device=x.device)]
        cost.restore(counts)
        h_inner = state["h"]
        if h_inner.grad_fn is not None:
            bwd = {}

            def inner_starts(grads):
                bwd["start"] = cost.snapshot()

            def inner_ends(grads):
                cost.add_since(bwd.pop("start"), cost.snapshot(), k)
                held.clear()

            h_inner.grad_fn.register_prehook(inner_starts)
            hs[-1].grad_fn.register_prehook(inner_ends)
        state = step(s - 1, state)
        hs += [h_inner.detach()] * k + [h_inner, state["h"]]
        y = torch.stack(hs, dim=1).to(x.dtype)
        return xlstm._slstm_out(params, cfg, y), state

    xlstm.slstm_forward = forward
    try:
        yield
    finally:
        xlstm.slstm_forward = orig


def count_cell(cell, mesh, *, chips: int, cfg, shape,
               max_ops: int = MAX_LOCAL_OPS):
    """Run the cell's step once under the counters: (RooflineTerms,
    OpCost, peak live bytes of rank 0)."""
    grad = cell.kind == "train"
    with set_active(mesh), torch.set_grad_enabled(grad), \
            counting(cell.model, *_tensors_of(cell.args_abs),
                     fake_mode=cell.fake_mode,
                     max_ops=max_ops) as (cost, mem), \
            _microbatch_counted_once(cost, cell.n_microbatches), \
            _slstm_counted_once(cost, mem):
        cell.fn(*cell.args_abs)
    terms = analyze_cell(cost, chips=chips, model_flops_total=(
        cell_model_flops(cfg, shape, cell.kind)))
    return terms, cost, peak_bytes(mem)


def _tensors_of(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for k in tree.__dataclass_fields__
                for t in _tensors_of(getattr(tree, k))]
    return []


def run_cell(arch: str, shape: str, *, multi_pod: bool, out_dir: pathlib.Path,
             verbose: bool = True) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = 512 if multi_pod else 256
    record = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "chips": chips, "status": "?"}
    t0 = time.time()
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi_pod)
            cell = build_cell(arch, shape, mesh)
            if cell.kind == "skip":
                record.update(status="skip", notes=cell.notes)
                _write(out_dir, record)
                if verbose:
                    print(f"[dryrun] {arch} x {shape} x {mesh_name}: "
                          f"SKIP ({cell.notes})")
                return record
            record["kind"] = cell.kind
            record["notes"] = cell.notes
            t_build = time.time() - t0
            terms, cost, peak = count_cell(cell, mesh, chips=chips,
                                           cfg=ARCHS[arch],
                                           shape=SHAPES[shape])
            t_count = time.time() - t0 - t_build
        record.update(
            status="ok",
            build_s=round(t_build, 2),
            count_s=round(t_count, 2),
            memory_source="torch MemTracker: peak live bytes of rank 0's "
                          "local shards over the step",
            per_device_hbm_bytes=int(peak),
            fits_hbm=bool(peak <= hw.TARGET.hbm_bytes),
            roofline=terms.as_dict(),
            replicated_ops=dict(cost.replicated_ops),
            n_ops=cost.n_ops,
        )
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {mesh_name}: OK "
                  f"(build {t_build:.1f}s count {t_count:.1f}s, "
                  f"{cost.n_ops} local ops)")
            print(f"  per-device peak: {peak/2**30:.2f} GiB "
                  f"(fits {hw.TARGET.hbm_bytes/1e9:.0f} GB: "
                  f"{record['fits_hbm']})")
            print(f"  cost: flops/dev={terms.flops:.3e} "
                  f"bytes/dev={terms.hbm_bytes:.3e} "
                  f"coll/dev={terms.collective_bytes:.3e}")
            print(f"  roofline: compute={terms.compute_s*1e3:.2f}ms "
                  f"memory={terms.memory_s*1e3:.2f}ms "
                  f"collective={terms.collective_s*1e3:.2f}ms "
                  f"-> dominant={terms.dominant} "
                  f"useful_flops_ratio={terms.useful_flops_ratio:.3f}")
            if cost.replicated_ops:
                print(f"  replicated (no sharding rule): "
                      f"{dict(cost.replicated_ops)}")
    except Exception as e:  # noqa: BLE001 — record and continue
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape} x {mesh_name}: "
                  f"ERROR {type(e).__name__}: {str(e)[:300]}")
    record["wall_s"] = round(time.time() - t0, 2)
    _write(out_dir, record)
    return record


def _write(out_dir: pathlib.Path, record: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / (f"{record['arch']}__{record['shape']}__"
                      f"{record['mesh']}.json")
    path.write_text(json.dumps(record, indent=1, default=str))


def _run_one(cell, out_dir):
    arch, shape, multi_pod = cell
    return run_cell(arch, shape, multi_pod=multi_pod, out_dir=out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, each process one fake "
                         "world at a time (default 1)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = pathlib.Path(args.out)
    todo = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=ctx) as pool:
            records = list(pool.map(_run_one, todo, [out_dir] * len(todo)))
    else:
        records = [_run_one(t, out_dir) for t in todo]
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"[dryrun] done: ok={n_ok} skip={n_skip} error={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
