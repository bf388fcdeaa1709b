"""One run of one cell: set-up, the measured window, the check, the result.

Everything particular to a cell is data found by name: `BENCHMARK.json`
names the cell's configuration and traffic mix; the configuration's file
(its `file`) holds its sizes, laws and entry; `traffic/<mix>.json` the
mix; `checks/<cell>.json` the limits of the comparison; `entries/<entry>.py`
drives the program; `metrics/<metric>.py` reads a per-layer metric.

The window is a closed loop with one client: tests run back to back until
`seconds` have passed, and every test that started in it ends in it and
counts. Each test draws a fresh factor (and covariates) and a fresh
permutation seed from (seed, test index). After the window the program's
state is let go and the reference (reference/) recomputes a sample of the
window's tests, drawn from the seed, in float64.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import random
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import data, roofline, tracing
from .reference import permanova as reference

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
WARMUP_TESTS = 1
# a compared number where there is nothing to compare (a test without an
# answer, a non-finite F): finite, so that the result stays strict JSON
NO_MATCH = 1e30


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


# Every key a configuration or a traffic file may hold, with the values the
# harness implements (None: any value of the key's kind). Text keys
# document and are not read; any other key, or a value outside its set, is
# refused, so that a file cannot ask for what the harness would not run.
TEXT = ("name", "source", "assumed", "guarantees")
CONFIG_KEYS = {"entry": None, "n_samples": None, "n_features": None,
               "metric": {"braycurtis"}, "dtype": {"float32"},
               "table_law": None, "call": None}
TRAFFIC_KEYS = {"loop": {"closed"}, "n_groups": None, "group_law": None,
                "n_perms": None, "covariates": None, "strata": None}


def validate(what: str, spec: dict, keys: dict) -> dict:
    """`spec` as read, or ValueError naming a key or value not
    implemented."""
    for k, v in spec.items():
        if k in TEXT:
            continue
        if k not in keys:
            raise ValueError(f"{what}: key {k!r} is not implemented")
        if keys[k] is not None and v not in keys[k]:
            raise ValueError(f"{what}: {k} = {v!r} is not implemented "
                             f"(only {sorted(keys[k])})")
    metric = spec.get("call", {}).get("metric", spec.get("metric"))
    if metric != spec.get("metric"):
        raise ValueError(f"{what}: call.metric {metric!r} is not the "
                         f"configuration's metric")
    return spec


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: Dict[str, str]     # metric name -> unit
    per_layer: Dict[str, str]


def cell(name: str, spec: Optional[dict] = None, root: Path = REPO) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `spec`), built from its
    files under `root`."""
    spec = load_json(root / "BENCHMARK.json") if spec is None else spec
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = {m["name"]: m["unit"] for m in spec["end_to_end"]
           if name in m.get("workloads", [name])}
    layer = {m["name"]: m["unit"] for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in e2e
                              else [])}
    return Cell(name=name, chips=int(w["chips"]),
                config=validate(conf["file"], load_json(root / conf["file"]),
                                CONFIG_KEYS),
                traffic=validate(w["traffic"], load_json(
                    root / "bench" / "traffic" / f"{w['traffic']}.json"),
                    TRAFFIC_KEYS),
                check=load_json(root / "bench" / "checks" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def module(kind: str, name: str, root: Path = REPO):
    """bench/<kind>/<name>.py, loaded by its path."""
    path = root / "bench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Test:
    index: int
    factor: torch.Tensor
    covariates: Optional[List[torch.Tensor]]
    strata: Optional[torch.Tensor]
    perm_seed: int
    n_groups: int
    n_perms: int


class Workload:
    """A cell's inputs at the sizes of its files (`sizes` overrides keys
    of the configuration and the mix: the CPU tests run them small)."""

    def __init__(self, c: Cell, seed: int, device, sizes=None):
        sizes = sizes or {}
        self.cell = c
        self.config = {**c.config, **{k: v for k, v in sizes.items()
                                      if k in c.config}}
        self.traffic = {**c.traffic, **{k: v for k, v in sizes.items()
                                        if k in c.traffic}}
        self.call_kwargs = {**self.config.get("call", {}),
                            **sizes.get("call", {})}
        self.seed, self.device = int(seed), torch.device(device)
        self.n = int(self.config["n_samples"])
        tr = self.traffic
        self.n_groups = int(tr["n_groups"])
        self.n_perms = int(tr["n_perms"])
        self.n_cov = int(tr.get("covariates", 0))
        self.group_sizes = data.law_sizes(self.n, self.n_groups,
                                          tr["group_law"])
        self.strata = data.strata(self.n, tr.get("strata"), self.seed,
                                  self.device)
        self.entry = module("entries", self.config["entry"])

    def make_inputs(self):
        """The resident input the entry takes: the table, or Bray-Curtis
        of it (then the table is let go)."""
        cfg = self.config
        x = data.abundance(self.n, int(cfg["n_features"]), self.seed,
                           cfg["table_law"], self.device)
        if self.entry.INPUT == "table":
            return x
        return data.braycurtis_matrix(x)

    def test(self, i: int) -> Test:
        gen = data.generator(self.device, self.seed, "test", i)
        factor = data.assign(self.group_sizes, gen, self.device)
        covs = (data.covariates(self.n, self.n_cov, gen, self.device)
                if self.n_cov else None)
        return Test(i, factor, covs, self.strata,
                    data.mix(self.seed, "perms", i) & 0x7FFFFFFF,
                    self.n_groups, self.n_perms)

    def call(self, inputs, t: Test):
        return self.entry.call(inputs, t, self.call_kwargs)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or 'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ---------------------------------------------------------------------------
# The check against the reference.
# ---------------------------------------------------------------------------

def reference_nulls(t: Test, d2: torch.Tensor, precision: str = "f64"):
    """The reference's null of each term of test t on D2."""
    if t.covariates:
        return reference.design_test(d2, t.factor, t.n_groups, t.covariates,
                                     n_perms=t.n_perms, seed=t.perm_seed,
                                     precision=precision)
    return reference.label_test(d2, t.factor, t.n_groups, n_perms=t.n_perms,
                                seed=t.perm_seed, strata=t.strata,
                                precision=precision)


def squared(wl: Workload, inputs, precision: str = "f64") -> torch.Tensor:
    """The reference's D2 from what the benchmark made: the matrix, or
    Bray-Curtis of the table computed again."""
    if wl.entry.INPUT == "table":
        return reference.squared_braycurtis(inputs, precision)
    return reference.squared_from_matrix(inputs, precision)


def compare(outs, refs, f_limit: float) -> Dict[str, float]:
    """f_gap: the widest gap of any F (observed and every permutation, each
    term) on the scale F + dof_resid / df (the relative gap of s_T / s_W
    for a factor); p_out: by how many permutations a p lies outside what
    the reference's F allows, F within the f_gap limit on both sides
    (0 when it lies inside)."""
    f_gap, p_out = 0.0, 0.0
    if len(outs) != len(refs):
        return {"f_gap": NO_MATCH, "p_out": NO_MATCH}
    for o, r in zip(outs, refs):
        f = o.f.to(torch.float64).cpu()
        if (f.shape != r.f.shape or not bool(torch.isfinite(f).all())
                or not bool(torch.isfinite(r.f).all())):
            return {"f_gap": NO_MATCH, "p_out": NO_MATCH}
        scale = r.f + r.dof_resid / r.df
        f_gap = max(f_gap, float(((f - r.f).abs() / scale).max()))
        tol = f_limit * (scale[1:] + scale[0])
        rest = r.f[1:] - r.f[0]
        lo, hi = int((rest > tol).sum()), int((rest >= -tol).sum())
        count = round(o.p * r.f.shape[0]) - 1
        p_out = max(p_out, float(max(0, lo - count, count - hi)))
    return {"f_gap": f_gap, "p_out": p_out}


def check(wl: Workload, inputs, outs: Dict[int, list], sample: List[int]
          ) -> Dict[str, float]:
    """The widest f_gap and p_out over the sampled tests."""
    lim = float(wl.cell.check["f_gap"])
    worst = {"f_gap": 0.0, "p_out": 0.0}
    d2 = squared(wl, inputs)
    for i in sample:
        t = wl.test(i)
        got = compare(outs[i], reference_nulls(t, d2), lim)
        worst = {k: max(worst[k], got[k]) for k in worst}
    del d2
    return worst


def sample_tests(seed: int, done: int, k: int) -> List[int]:
    return sorted(random.Random(data.mix(seed, "sample")).sample(
        range(done), min(k, done)))


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------

class Ctx:
    """What a per-layer reader reads."""

    def __init__(self, wl: Workload, trace, tests: int):
        self.trace, self.tests = trace, tests
        self.config, self.traffic = wl.config, wl.traffic
        self.roofline = roofline
        self.n, self.n_total = wl.n, wl.n_perms + 1
        self.group_sizes = wl.group_sizes
        self.basis_cols = 1 + wl.n_cov + wl.n_groups - 1


def run(c: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
        t_start: Optional[float] = None, sizes=None, log=sys.stderr) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_run = time.perf_counter()
    wl = Workload(c, seed, dev, sizes)
    inputs = wl.make_inputs()
    _sync(dev)
    t_inputs = time.perf_counter()
    for w in range(WARMUP_TESTS):
        wl.call(inputs, wl.test(-1 - w))
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s: start to harness {t_run - t_start:.3f}, "
          f"inputs {t_inputs - t_run:.3f}, warm-up "
          f"{t_start + setup_s - t_inputs:.3f}", file=log, flush=True)

    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if trace:
        from repro_torch import obs
        obs.enable(trace=True, metrics=False)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])])
        prof.__enter__()
    outs: Dict[int, list] = {}
    times: List[float] = []
    failed = 0
    with torch.profiler.record_function(tracing.WINDOW):
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            t = wl.test(i)
            ts = time.perf_counter()
            try:
                got = wl.call(inputs, t)
            except Exception:           # a failed test counts as failed
                traceback.print_exc(file=log)
                failed += 1
                got = None
            times.append(time.perf_counter() - ts)
            if got is not None:     # to the host: no window memory of ours
                outs[i] = [o._replace(f=o.f.cpu()) for o in got]
            i += 1
        t1 = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from repro_torch import obs
        obs.disable()
        tr = tracing.Trace(tracing.kineto_events(prof))
        del prof
        tr.save(tracing.trace_path(c.name, seed))

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "test_s": (t1 - t0) / max(i, 1),
                  "peak_mib": (window_peak - base) / 2 ** 20}
        values["test_p90_s"] = (statistics.quantiles(
            times, n=10, method="inclusive")[8] if len(times) >= 2
            else times[0])
        metrics = {m: {"value": values[m], "unit": unit}
                   for m, unit in c.end_to_end.items() if m in values}
    else:
        ctx = Ctx(wl, tr, i)
        for m, unit in c.per_layer.items():
            v = module("metrics", m).read(ctx)
            if v is not None:
                metrics[m] = {"value": v, "unit": unit}

    # the check: the program's state let go, then the reference
    if cuda:
        torch.cuda.empty_cache()
    done = sorted(outs)
    sample = [done[j] for j in sample_tests(seed, len(done),
                                            int(c.check["sample"]))]
    got = check(wl, inputs, outs, sample) if sample else {
        "f_gap": NO_MATCH, "p_out": NO_MATCH}
    limits = {"f_gap": float(c.check["f_gap"]),
              "p_out": float(c.check["p_out"])}
    correct = (failed == 0 and i > 0 and len(done) == i
               and all(got[k] <= limits[k] for k in limits))
    result = {"correct": bool(correct), "attempted": i, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else "cpu"),
                         "count": 1,
                         "memory_peak_bytes": int(max(setup_peak,
                                                      window_peak))}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["card"] = {"power_limit": power_limit() if cuda else "none",
                      "sampled_tests": sample}
    result["checks"] = {k: {"value": got[k], "limit": limits[k]}
                        for k in limits}
    return result
