"""The port's roofline counting (`roofline.op_cost`, `roofline.analysis`)
on the CPU.

`model_flops` equals the reference's to the bit for every architecture;
the counted FLOPs of the smoke internlm2 gradient step fall within 0.8-2.0
x 6ND (the reference's own bar for its loop-aware HLO count) and equal
torch's FlopCounterMode on the same real step exactly; a hand-made 2-rank
case gives exact per-device FLOPs, all-gather bytes and link; the terms'
arithmetic and the interconnect rule (NVLink within an 8-rank node,
InfiniBand otherwise).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.configs.registry import ARCHS, SMOKES, list_archs  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.roofline import analysis, op_cost  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


@pytest.mark.parametrize("kind,tokens", [("train", 256 * 4096),
                                         ("inference", 128)])
def test_model_flops_equal_the_reference_exactly(kind, tokens):
    for arch in list_archs():
        jm = jmodel.build_model(JARCHS[arch])
        want = janalysis.model_flops(JARCHS[arch], jm.abstract_params(),
                                     jm.param_axes(), tokens=tokens,
                                     kind=kind)
        specs = tmodel.param_specs(ARCHS[arch])
        got = analysis.model_flops(ARCHS[arch], specs,
                                   dryrun._spec_axes(specs), tokens=tokens,
                                   kind=kind)
        assert got == want, (arch, got, want)
        fr = analysis.active_param_fraction_tree(jm.param_axes(),
                                                 ARCHS[arch])
        jfr = janalysis.active_param_fraction_tree(jm.param_axes(),
                                                   JARCHS[arch])
        assert (fr is None) == (jfr is None)
        if fr is not None:
            assert jax.tree.leaves(fr) == jax.tree.leaves(jfr)


def _smoke_grad_step(fake: bool):
    """(model, step()) of the smoke internlm2's loss + gradient at (4, 64),
    on fake or real CPU tensors."""
    cfg = SMOKES["internlm2-1.8b"]
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    if fake:
        mode = cells.fake_mode()
        with mode:
            model = tmodel.build_model(cfg, device="cpu")
            batch = {k: torch.empty(v.shape, dtype=v.dtype)
                     for k, v in batch.items()}
    else:
        mode = None
        model = tmodel.build_model(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    return model, mode, lambda: tstep.value_and_grad(model, batch)


def test_counted_gradient_step_within_the_6nd_bar():
    model, mode, step = _smoke_grad_step(fake=True)
    with op_cost.counting(model, fake_mode=mode) as (cost, mem):
        step()
    n = sum(p.numel() for p in model.parameters())
    six_nd = 6 * n * 4 * 64
    assert 0.8 * six_nd < cost.flops < 2.0 * six_nd, (cost.flops, six_nd)
    assert cost.coll_bytes == 0 and cost.hbm_bytes > 0
    assert op_cost.peak_bytes(mem) >= 4 * n      # the f32 weights at least


def test_counted_flops_equal_flopcountermode_on_the_real_step():
    from torch.utils.flop_counter import FlopCounterMode

    _, mode, fake_step = _smoke_grad_step(fake=True)
    with op_cost.counting(fake_mode=mode) as (cost, _):
        fake_step()
    _, _, real_step = _smoke_grad_step(fake=False)
    with FlopCounterMode(display=False) as fc:
        real_step()
    assert cost.flops == fc.get_total_flops()


def test_two_rank_fsdp_product_counts_exactly():
    """x (8, 16) batch-sharded, w (16, 32) FSDP-sharded over 'data' on 2
    ranks: the weight is gathered (one all-gather of the 8 x 32 f32
    local shard, 1,024 B, over NVLink), then each rank multiplies its 4
    rows: 2 x 4 x 16 x 32 FLOPs, and reads x's and w's shards and writes
    its rows (256 + 2,048 + 512 B)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    with fake_world(2):
        mesh = make_mesh((2,), ("data",), device_type="cpu")
        mode = cells.fake_mode()
        with mode:
            x = distribute_tensor(torch.empty(8, 16), mesh, [Shard(0)],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(16, 32), mesh, [Shard(0)],
                                  src_data_rank=None)
        with rules.set_active(mesh), op_cost.counting(
                fake_mode=mode) as (cost, _):
            y = x @ rules.gather_weight(w)
        assert tuple(y.placements) == (Shard(0),)
    assert not dist.is_initialized()
    assert cost.flops == 2 * 4 * 16 * 32
    assert cost.coll_by_kind == {"all-gather": 1024, "all-reduce": 0,
                                 "reduce-scatter": 0, "all-to-all": 0}
    assert cost.coll_counts["all-gather"] == 1
    assert cost.coll_by_link == {"nvlink": 1024, "ib": 0}
    assert cost.hbm_bytes == 256 + 2048 + 512
    terms = analysis.analyze_cell(cost, chips=2)
    assert terms.collective_s == 1024 / hw.TARGET.nvlink_bandwidth


def test_terms_arithmetic_and_the_interconnect_rule():
    chip = hw.TARGET
    assert (chip.nvlink_bandwidth, chip.ib_bandwidth, chip.node_gpus) == \
        (450e9, 50e9, 8)
    assert op_cost.link_of(range(8)) == "nvlink"
    assert op_cost.link_of([8, 12, 15]) == "nvlink"
    assert op_cost.link_of([7, 8]) == "ib"
    assert op_cost.link_of(range(0, 256, 16)) == "ib"   # a 'data' group
    assert op_cost.link_of(range(16)) == "ib"           # a 'model' group
    cost = op_cost.OpCost(flops=1e12, hbm_bytes=3.35e9, coll_bytes=5e8)
    cost.coll_by_kind["all-gather"] = 5e8
    cost.coll_by_link.update(nvlink=4.5e8, ib=5e7)
    t = analysis.analyze_cell(cost, chips=4, model_flops_total=4e12)
    assert t.compute_s == 1e12 / chip.peak_flops_bf16
    assert t.memory_s == 3.35e9 / chip.hbm_bandwidth
    assert t.collective_s == 4.5e8 / 450e9 + 5e7 / 50e9
    assert t.dominant == "collective"
    assert t.useful_flops_ratio == 4e12 / (1e12 * 4)
    d = t.as_dict()
    assert set(d) >= {"flops", "hbm_bytes", "collective_bytes", "compute_s",
                      "memory_s", "collective_s", "dominant",
                      "collective_detail", "model_flops_total",
                      "useful_flops_ratio"}
    assert d["collective_links"] == {"nvlink": 4.5e8, "ib": 5e7}
    f32 = analysis.analyze_cell(cost, chips=4, dtype_flops="f32")
    assert f32.compute_s == 1e12 / chip.peak_flops_f32


def test_an_op_without_a_rule_replicates_only_the_inner_axes():
    """A view DTensor cannot shard (a 6-wide dim sharded 2-ways split
    into (3, 2)) runs with the 'model' axis replicated and the batch
    still sharded over 'data': one all-gather over 'model' of the local
    (2, 3) f32 shard, the op named in `replicated_ops`."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        mode = cells.fake_mode()
        with mode:
            x = distribute_tensor(torch.empty(4, 6), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
        with op_cost.counting(fake_mode=mode) as (cost, _):
            y = x.view(4, 3, 2)
        assert tuple(y.placements) == (Shard(0), Replicate())
    assert not dist.is_initialized()
    assert dict(cost.replicated_ops) == {"aten.view.default": 1}
    assert cost.coll_counts == {"all-gather": 1, "all-reduce": 0,
                                "reduce-scatter": 0, "all-to-all": 0}
    assert cost.coll_by_kind["all-gather"] == 2 * 3 * 4


def test_a_fault_of_the_program_raises_and_is_not_replicated():
    """A product whose global shapes disagree ((4, 6) @ (5, 3)) fails
    for every sharding: it leaves the count with the op named, where an
    op DTensor merely has no rule for would be replicated; no collective
    of the failed attempt is counted."""
    from torch.distributed.tensor import Shard, distribute_tensor

    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        mode = cells.fake_mode()
        with mode:
            x = distribute_tensor(torch.empty(4, 6), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            w = distribute_tensor(torch.empty(5, 3), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
        with pytest.raises(RuntimeError, match=r"aten\.mm"):
            with op_cost.counting(fake_mode=mode) as (cost, _):
                x @ w
    assert not dist.is_initialized()
    assert dict(cost.replicated_ops) == {}
    assert sum(cost.coll_counts.values()) == 0


def test_the_op_budget_stops_a_count_and_names_the_op():
    model, mode, step = _smoke_grad_step(fake=True)
    with pytest.raises(op_cost.OpBudgetExceeded, match=r"more than 50 "
                       r"local ops: aten\..* in models/"):
        with op_cost.counting(model, fake_mode=mode, max_ops=50):
            step()
