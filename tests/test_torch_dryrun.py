"""The port's dry-run cells (`launch.cells`, `launch.dryrun`) and report
tables (`roofline.report`) against the reference's on the CPU.

`input_specs` gives the reference's shapes and dtypes for all 40 (arch x
shape) cells, full and smoke (32 run, 8 skip; decode caches from the
port's `init_caches` on fake tensors); `pick_microbatches` the
reference's counts; the reference test's six smoke cells end `ok` on a
(2, 2) fake mesh and the seventh `skip`, with collective bytes counted;
sLSTM's time loop counted once a step counts what the unrolled loop
counts, with its peak, and a 4,096-step loop stays under the op budget;
a record written by `run_cell` keeps the reference's keys; and the
report tables render the reference's text from one record set, but for
the card's remedies and capacity. Shapes, counts and text compare
exactly.
"""

import contextlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import torch.distributed as dist  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.configs.registry import ARCHS, SMOKES, list_archs  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

real_slstm_counted_once = dryrun._slstm_counted_once

_JDTYPES = {"int32": torch.int32, "uint32": None, "bfloat16": torch.bfloat16,
            "float32": torch.float32, "float8_e4m3fn": torch.float8_e4m3fn}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_input_specs_equal_the_reference_on_all_40_cells(smoke):
    n_cells = n_skip = 0
    for arch in list_archs():
        for shape_name, shape in SHAPES.items():
            runs, _ = shape_applicable(ARCHS[arch], shape)
            assert (runs, _) == shape_applicable(
                JARCHS[arch], JSHAPES[shape_name])
            if not runs:
                n_skip += 1
                continue
            n_cells += 1
            want = jcells.input_specs(arch, shape_name, smoke=smoke)
            got = cells.input_specs(arch, shape_name, smoke=smoke)
            if shape.kind == "decode":
                # the reference's key_bits is the port's generator
                assert want.pop("key_bits").shape == (2,)
                assert isinstance(got.pop("generator"), torch.Generator)
                assert got["cache_len"].dtype == torch.int32
            jw, tw = _flat(want), _flat(got)
            assert [p for p, _ in jw] == [p for p, _ in tw], (arch,
                                                               shape_name)
            for (path, w), (_, t) in zip(jw, tw):
                assert tuple(t.shape) == tuple(w.shape), (arch, shape_name,
                                                         path)
                assert t.dtype == _JDTYPES[str(w.dtype)], (arch, path)
    assert n_cells + n_skip == 40
    assert n_skip == 8   # 8 full-attention archs skip long_500k


def test_pick_microbatches_equals_the_reference():
    for arch in list_archs():
        for shape_name in SHAPES:
            for ways in (1, 16, 32):
                assert cells.pick_microbatches(
                    ARCHS[arch], SHAPES[shape_name], data_ways=ways) == \
                    jcells.pick_microbatches(JARCHS[arch],
                                             JSHAPES[shape_name],
                                             data_ways=ways), (arch, shape_name)


SMOKE_CELLS = [
    ("internlm2-1.8b", "train_4k"),      # dense train
    ("grok-1-314b", "train_4k"),         # moe train (experts looped)
    ("zamba2-1.2b", "decode_32k"),       # hybrid decode
    ("xlstm-350m", "decode_32k"),        # xlstm decode
    ("whisper-base", "prefill_32k"),     # encdec prefill
    ("internvl2-76b", "train_4k"),       # vlm train
    ("qwen1.5-110b", "long_500k"),       # skip rule
]


def test_smoke_cells_run_and_count_on_a_fake_mesh():
    results = {}
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        for arch, shape in SMOKE_CELLS:
            cell = cells.build_cell(arch, shape, mesh, smoke=True)
            if cell.kind == "skip":
                results[(arch, shape)] = {"status": "skip"}
                continue
            terms, cost, peak = dryrun.count_cell(
                cell, mesh, chips=4, cfg=SMOKES[arch], shape=SHAPES[shape])
            assert terms.flops > 0, (arch, shape)
            assert terms.hbm_bytes > 0, (arch, shape)
            assert peak > 0, (arch, shape)
            assert terms.dominant in ("compute", "memory", "collective")
            results[(arch, shape)] = {"status": "ok",
                                      "coll": terms.collective_bytes}
    assert not dist.is_initialized()
    assert results[("qwen1.5-110b", "long_500k")]["status"] == "skip"
    ok = [k for k, v in results.items() if v["status"] == "ok"]
    assert len(ok) == 6, results
    # sharded programs must actually communicate
    assert any(v.get("coll", 0) > 0 for v in results.values()), results


def _count_xlstm(kind, seq, *, loops_once, monkeypatch):
    """xlstm-smoke's cell at (4, seq) on a (2, 2) fake mesh: (OpCost,
    peak, sLSTM steps run); the time loop unrolled without `loops_once`."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import xlstm

    monkeypatch.setattr(cells, "ARCHS", SMOKES)   # smoke widths, any seq
    monkeypatch.setattr(dryrun, "_slstm_counted_once", (
        real_slstm_counted_once if loops_once
        else lambda cost, mem: contextlib.nullcontext()))
    steps = []
    cell_fn = xlstm._slstm_cell
    monkeypatch.setattr(xlstm, "_slstm_cell",
                        lambda *a: steps.append(1) or cell_fn(*a))
    shape = ShapeConfig(f"{kind}_4x{seq}", seq, 4, kind)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        cell = cells.build_cell("xlstm-350m", shape, mesh, n_microbatches=1)
        _, cost, peak = dryrun.count_cell(
            cell, mesh, chips=4, cfg=SMOKES["xlstm-350m"], shape=shape)
    assert not dist.is_initialized()
    return cost, peak, len(steps)


@pytest.mark.parametrize("kind,seq", [("prefill", 32), ("train", 12)])
def test_slstm_loop_counted_once_equals_unrolled(kind, seq, monkeypatch):
    """One sLSTM step counted and added S - 4 times (the reference's scan
    body times its trip count), forward and backward, counts what the
    unrolled loop counts; the held bytes keep its peak."""
    once, peak_once, ran_once = _count_xlstm(kind, seq, loops_once=True,
                                             monkeypatch=monkeypatch)
    full, peak_full, ran_full = _count_xlstm(kind, seq, loops_once=False,
                                             monkeypatch=monkeypatch)
    n_slstm = 2                          # xlstm-smoke: 4 layers, every 2nd
    assert (ran_once, ran_full) == (4 * n_slstm, seq * n_slstm)
    assert full.coll_bytes > 0
    for name in ("flops", "hbm_bytes", "coll_bytes"):
        assert getattr(once, name) == pytest.approx(getattr(full, name),
                                                    rel=1e-6), name
    for name in ("coll_by_kind", "coll_by_link"):
        for key, v in getattr(full, name).items():
            assert getattr(once, name)[key] == pytest.approx(v, rel=1e-6), \
                (name, key)
    assert abs(peak_once - peak_full) <= 0.01 * peak_full, (peak_once,
                                                            peak_full)


def test_long_slstm_loop_counts_under_the_op_budget(monkeypatch):
    """At S = 4,096 the sLSTM loop runs 4 steps a layer under the default
    op budget and counts S steps' ops."""
    seq = 4096
    cost, peak, ran = _count_xlstm("prefill", seq, loops_once=True,
                                   monkeypatch=monkeypatch)
    assert ran == 4 * 2
    assert cost.flops > 0 and peak > 0
    # each sLSTM step runs > 100 local ops (DTensor's redistributions)
    assert cost.n_ops > 100 * seq * 2


def test_run_cell_writes_the_reference_record(tmp_path, monkeypatch):
    """A production-mesh record at smoke size (the cell builder is pointed
    at the smoke configs): the reference's keys and file name."""
    real = cells.build_cell
    monkeypatch.setattr(dryrun, "build_cell", lambda a, s, m: real(
        a, s, m, smoke=True))
    monkeypatch.setattr(dryrun, "ARCHS", SMOKES)
    rec = dryrun.run_cell("qwen2-moe-a2.7b", "decode_32k", multi_pod=False,
                          out_dir=tmp_path, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    on_disk = json.loads((tmp_path / "qwen2-moe-a2.7b__decode_32k__"
                                     "pod16x16.json").read_text())
    for key in ("arch", "shape", "mesh", "chips", "status", "kind",
                "notes", "per_device_hbm_bytes", "fits_hbm", "roofline",
                "wall_s"):
        assert key in on_disk, key
    assert on_disk["chips"] == 256
    assert set(on_disk["roofline"]) >= {
        "flops", "hbm_bytes", "collective_bytes", "compute_s", "memory_s",
        "collective_s", "dominant", "collective_detail",
        "model_flops_total", "useful_flops_ratio"}
    assert on_disk["memory_source"].startswith("torch MemTracker")
    skip = dryrun.run_cell("internlm2-1.8b", "long_500k", multi_pod=True,
                           out_dir=tmp_path, verbose=False)
    assert skip["status"] == "skip" and skip["chips"] == 512
    assert not dist.is_initialized()


def _records():
    rng = np.random.default_rng(0)
    recs = {"pod16x16": {}, "pod2x16x16": {}}
    doms = ["compute", "memory", "collective"]
    for mesh in recs:
        for i, arch in enumerate(report.ARCH_ORDER):
            for j, shape in enumerate(report.SHAPE_ORDER):
                if shape == "long_500k" and arch not in ("zamba2-1.2b",
                                                         "xlstm-350m"):
                    r = {"status": "skip"}
                elif (i + j) % 7 == 3:
                    r = {"status": "error",
                         "error": "RuntimeError: " + "x" * 60}
                else:
                    t = rng.uniform(0, 2, 4)
                    r = {"status": "ok",
                         "per_device_hbm_bytes": int(rng.uniform(0, 9e10)),
                         "fits_hbm": bool(rng.integers(2)),
                         "roofline": {"compute_s": t[0], "memory_s": t[1],
                                      "collective_s": t[2],
                                      "dominant": doms[(i + j) % 3],
                                      "useful_flops_ratio": t[3]}}
                r.update(arch=arch, shape=shape, mesh=mesh)
                recs[mesh][(arch, shape)] = r
    return recs


def test_report_tables_render_the_reference_text(tmp_path):
    recs = _records()
    for mesh, rs in recs.items():
        for (arch, shape), r in rs.items():
            (tmp_path / f"{arch}__{shape}__{mesh}.json").write_text(
                json.dumps(r))
    single = report.load(tmp_path, "pod16x16")
    multi = report.load(tmp_path, "pod2x16x16")
    assert single == jreport.load(tmp_path, "pod16x16")
    assert multi == jreport.load(tmp_path, "pod2x16x16")

    assert report.render_multipod(multi) == jreport.render_multipod(multi)
    want = jreport.render_roofline(single)
    for dom, note in jreport.FIX_NOTES.items():
        want = want.replace(note, report.FIX_NOTES[dom])
    assert report.render_roofline(single) == want
    assert report.render_summary(single, multi) == \
        jreport.render_summary(single, multi).replace(
            "16 GiB/chip", report.CAPACITY)
    for r in single.values():
        assert report.fmt_row(r)[0] == jreport.fmt_row(r)[0]
    assert report.render_table(["a", "bb"], [[1, 2]]) == \
        jreport.render_table(["a", "bb"], [[1, 2]])

    page = tmp_path / "page.md"
    page.write_text("<!-- DRYRUN_SUMMARY -->\n<!-- ROOFLINE_TABLE -->\n"
                    "<!-- MULTIPOD_TABLE -->\n")
    report.main(["--results", str(tmp_path), "--write", str(page)])
    text = page.read_text()
    assert "<!--" not in text and "| arch | shape |" in text
