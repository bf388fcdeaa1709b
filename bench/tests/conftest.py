import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# A cell at a size a CPU test holds: widths kept, the scale cut. 64
# features keep an all-zero row (Bray-Curtis 0/0) out of the table.
SMALL = {"n_samples": 400, "n_features": 64, "n_perms": 99}
CELLS = ("emp-matrix.labels",)

# Cells the harness runs but BENCHMARK.json holds back (PERF.md, Open
# questions): the features entry, a covariate design and strata, added as
# files under a copy of the checkout, as a later change would add them.
HELD_CONFIG = {
    "name": "features", "source": "a test", "entry": "pipeline",
    "n_samples": 25145, "n_features": 128, "metric": "braycurtis",
    "dtype": "float32", "table_law": {"gamma_shape": 0.7, "sparsity": 0.7},
    "call": {"metric": "braycurtis"}}
HELD_TRAFFIC = {
    "covariates": {"covariates": 2},
    "strata": {"strata": {"count": 97,
                          "law": {"kind": "zipf", "exponent": 1.0}}}}
HELD = {"features.labels": ("features", "labels", 5e-6),
        "features.covariates": ("features", "covariates", 3e-8),
        "emp-matrix.strata": ("emp-matrix", "strata", 5e-6)}
ALL = CELLS + tuple(HELD)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def copy_checkout(dest: Path) -> dict:
    """BENCHMARK.json and bench/ under dest; the spec, to be extended."""
    shutil.copytree(REPO / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A checkout holding every cell of ALL."""
    dest = tmp_path_factory.mktemp("held")
    spec = copy_checkout(dest)
    bench = dest / "bench"
    (bench / "configs" / "features.json").write_text(json.dumps(HELD_CONFIG))
    spec["configs"].append({"name": "features", "source": "a test",
                            "file": "bench/configs/features.json",
                            "reduced": [], "why": "a test"})
    labels = json.loads((bench / "traffic" / "labels.json").read_text())
    for mix, keys in HELD_TRAFFIC.items():
        (bench / "traffic" / f"{mix}.json").write_text(
            json.dumps({**labels, **keys}))
    for name, (config, mix, f_gap) in HELD.items():
        (bench / "checks" / f"{name}.json").write_text(json.dumps(
            {"f_gap": f_gap, "p_out": 0, "sample": 3}))
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": mix, "chips": 1, "why": "a test"})
    for m in spec["per_layer"]:
        if m["name"] == "engine_sweep_roofline":
            m["workloads"] = ["emp-matrix.labels", "emp-matrix.strata"]
    spec["per_layer"].append({
        "name": "fused_bridge_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "fused bridge", "moves": "test_s",
        "workloads": ["features.labels", "features.covariates"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


def small(c):
    """SMALL, and on the features entry the fused-kernel bridge (the one
    the planner picks for a (25,145, 128) table) pinned, since a small
    table would plan the dense bridge."""
    sizes = dict(SMALL)
    if c.config["entry"] == "pipeline":
        sizes["call"] = {"materialize": "fused-kernel"}
    return sizes


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
