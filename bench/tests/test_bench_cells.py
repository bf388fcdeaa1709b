"""The harness builds every cell from its files, takes a new cell from new
files alone, and prints the result the contract asks for."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench import harness
from conftest import ALL, CELLS, REPO, copy_checkout, small

SEED = 2 ** 31 + 977


def test_every_cell_builds_from_its_files(root):
    spec = harness.load_json(REPO / "BENCHMARK.json")
    assert [w["name"] for w in spec["workloads"]] == list(CELLS)
    held = harness.load_json(root / "BENCHMARK.json")
    assert [w["name"] for w in held["workloads"]] == list(ALL)
    for name in ALL:
        c = harness.cell(name, held, root)
        assert c.chips == 1
        assert "setup_s" in c.end_to_end and "test_s" in c.end_to_end
        assert c.per_layer, name
        harness.module("entries", c.config["entry"])
        for m in c.per_layer:
            assert callable(harness.module("metrics", m).read)
    assert "test_p90_s" not in harness.cell("features.covariates", held,
                                            root).end_to_end


def _with_mix(tmp_path, name, **keys):
    """A copy of the checkout with the labels mix changed by `keys` as a
    new traffic file, its check file and a cell `emp-matrix.<name>`."""
    spec = copy_checkout(tmp_path)
    mix = harness.load_json(REPO / "bench" / "traffic" / "labels.json")
    mix.update(keys)
    (tmp_path / "bench" / "traffic" / f"{name}.json").write_text(
        json.dumps(mix))
    shutil.copy(REPO / "bench" / "checks" / "emp-matrix.labels.json",
                tmp_path / "bench" / "checks" / f"emp-matrix.{name}.json")
    spec["workloads"].append({"name": f"emp-matrix.{name}",
                              "config": "emp-matrix", "traffic": name,
                              "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_a_new_traffic_file_is_a_new_cell(tmp_path):
    """A mix added as files (a traffic file, a check file, an entry in
    BENCHMARK.json) runs without an edit to any file already there."""
    root = _with_mix(tmp_path, "five", n_groups=5,
                     group_law={"kind": "zipf", "exponent": 0.5})
    c = harness.cell("emp-matrix.five", root=root)
    assert c.traffic["n_groups"] == 5
    r = harness.run(c, SEED, 0.2, False, device="cpu", sizes=small(c))
    assert r["correct"] and r["attempted"] >= 1


@pytest.mark.parametrize("keys", [{"loop": "open"}, {"arrivals": 4.0},
                                  {"dtype": "bfloat16"}],
                         ids=["open-loop", "unknown-key", "a-config-key"])
def test_a_file_asking_for_what_is_not_implemented_is_refused(tmp_path, keys):
    root = _with_mix(tmp_path, "odd", **keys)
    with pytest.raises(ValueError, match="not implemented"):
        harness.cell("emp-matrix.odd", root=root)


@pytest.mark.parametrize("keys", [{"dtype": "bfloat16"},
                                  {"metric": "jaccard"},
                                  {"call": {"metric": "jaccard"}},
                                  {"reference": "other.py"}])
def test_a_configuration_asking_for_what_is_not_implemented_is_refused(
        tmp_path, keys):
    copy_checkout(tmp_path)
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    path = tmp_path / "bench" / "configs" / "emp-matrix.json"
    path.write_text(json.dumps({**harness.load_json(path), **keys}))
    with pytest.raises(ValueError, match="not"):
        harness.cell("emp-matrix.labels", root=tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    c = harness.cell("emp-matrix.labels")
    r = harness.run(c, SEED, 0.3, trace, device="cpu", sizes=small(c))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in r
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"f_gap", "p_out"}
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(r["metrics"]) <= set(c.per_layer)
    else:
        assert set(r["metrics"]) == set(c.end_to_end)
        for m in r["metrics"].values():
            assert m["value"] >= 0 and m["unit"]
    json.dumps(r)


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "emp-matrix.labels",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = _run_py(REPO)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with BENCHMARK.json and bench/ but not the program."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_py(tmp_path, env)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.card
def test_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "emp-matrix.labels",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
