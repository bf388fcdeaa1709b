"""The port's sharding rules (`repro_torch.sharding`) against the
reference's on the CPU.

Every param leaf of every architecture (the full configs, the port's
model built on fake tensors) gets the reference's PartitionSpec on both
production meshes, the reference's taken on a `jax.sharding.AbstractMesh`
(no devices needed); the four cases of the reference's TestLogicalToSpec;
the placements a spec becomes on a DeviceMesh of a fake world; the
optimizer-state axes of AdamW, SGDM and Adafactor; a model's loss the
same with and without the activation constraints (a gloo world of one,
the weights DTensors); its prefill and decode logits the plain model's
on a gloo world of two with the KV caches sequence-sharded; and no fake
process group outliving its block. Specs are compared exactly (they are
data); the loss at f32 rtol 1e-6, the two-rank logits at rtol / atol
1e-5.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import SMOKES as JSMOKES  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.sharding import state as jstate  # noqa: E402
from repro_torch.configs.registry import ARCHS, SMOKES, list_archs  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import (fake_world, make_mesh,  # noqa: E402
                                     make_production_mesh, world_of_one)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.model import STACK_DEPTH  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.sharding import rules, state  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.sharding.rules import (RULES_MULTI_POD,  # noqa: E402
                                        RULES_SINGLE_POD, P, logical_to_spec)

MESHES = {
    "pod16x16": ({"data": 16, "model": 16}, ((16, 16), ("data", "model"))),
    "pod2x16x16": ({"pod": 2, "data": 16, "model": 16},
                   ((2, 16, 16), ("pod", "data", "model"))),
}


def _abstract_mesh(shape, names):
    return AbstractMesh(shape, names)


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))


def _key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _port_leaves(axes_tree, tree, prefix=()):
    """(path, axes, leaf) of the port's param tree; a stacked subtree's
    layers all share the path of the reference's stacked leaf."""
    if rules.is_axes(axes_tree):
        return [(prefix, axes_tree, tree)]
    if isinstance(axes_tree, dict):
        return [x for k in sorted(axes_tree)
                for x in _port_leaves(axes_tree[k], tree[k], prefix + (k,))]
    return [x for a, t in zip(axes_tree, tree)
            for x in _port_leaves(a, t, prefix)]


@pytest.fixture(scope="module")
def fake_models():
    out = {}
    for arch in list_archs():
        mode = cells.fake_mode()
        with mode:
            out[arch] = tmodel.build_model(ARCHS[arch], device="cpu")
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_every_param_leaf_gets_the_reference_spec(fake_models, mesh_name):
    sizes, (shape, names) = MESHES[mesh_name]
    amesh = _abstract_mesh(shape, names)
    n_leaves = 0
    for arch in list_archs():
        jm = jmodel.build_model(JARCHS[arch])
        ref = {}
        for (path, axes), (_, arr) in zip(
                _jax_leaves(jm.param_axes()),
                jax.tree_util.tree_leaves_with_path(jm.abstract_params())):
            ref[_key(path)] = (axes, tuple(
                jrules.logical_to_spec(axes, arr.shape, amesh)))
        m = fake_models[arch]
        seen = set()
        for path, axes, leaf in _port_leaves(m.param_axes(),
                                             m.param_tree()):
            ref_axes, ref_spec = ref[path]
            depth = STACK_DEPTH.get(path[0], 0)
            assert ref_axes[depth:] == axes, (arch, path)
            # the stacked dims are "layers" (replicated): the per-layer
            # leaf's spec is the reference's less its leading entries
            want = list(ref_spec[depth:])
            while want and want[-1] is None:
                want.pop()
            got = logical_to_spec(axes, leaf.shape, sizes)
            assert tuple(got) == tuple(want), (arch, path, got, ref_spec)
            seen.add(path)
        assert seen == set(ref), arch
        # the stacked spec tree gives the reference's spec leaf for leaf
        specs = tmodel.param_specs(ARCHS[arch])
        for path, (ref_axes, ref_spec) in ref.items():
            s = specs
            for k in path:
                s = s[k]
            assert s.axes == ref_axes
            assert tuple(logical_to_spec(s.axes, s.shape, sizes)) \
                == ref_spec, (arch, path)
        n_leaves += len(ref)
    assert n_leaves == 203


def _mesh_1():
    return {"data": 1, "model": 1}


class TestLogicalToSpec:
    def test_basic_mapping(self):
        spec = logical_to_spec(("embed", "mlp"), (64, 128), _mesh_1(),
                               RULES_SINGLE_POD)
        assert spec == P("data", "model")

    def test_indivisible_dim_dropped(self):
        spec = logical_to_spec((None, "mlp"), (7, 128), _mesh_1(),
                               RULES_SINGLE_POD)
        assert spec == P(None, "model")
        # and one that the mesh does not divide (60 experts' capacity on 16)
        spec = logical_to_spec(("mlp", "embed"), (60, 64),
                               {"data": 16, "model": 16}, RULES_SINGLE_POD)
        assert spec == P(None, "data")

    def test_trailing_nones_trimmed(self):
        spec = logical_to_spec(("batch", None, None), (8, 4, 4), _mesh_1(),
                               RULES_SINGLE_POD)
        assert spec == P("data")

    def test_multi_pod_batch_axes(self):
        assert RULES_MULTI_POD.rules["batch"] == ("pod", "data")
        assert RULES_MULTI_POD.rules == {
            **jrules.RULES_MULTI_POD.rules}
        assert RULES_SINGLE_POD.rules == jrules.RULES_SINGLE_POD.rules


def test_specs_become_placements_on_the_production_mesh():
    from torch.distributed.tensor import Replicate, Shard

    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        batch = logical_to_spec(("batch", None), (256, 4096), mesh)
        assert batch == P(("pod", "data"))
        assert rules.placements(batch, mesh) == (Shard(0), Shard(0),
                                                 Replicate())
        w = logical_to_spec(("embed", "mlp"), (8192, 49152), mesh)
        assert rules.placements(w, mesh) == (Replicate(), Shard(0),
                                             Shard(1))
    assert not dist.is_initialized()
    with fake_world(256):
        mesh = make_production_mesh()
        assert tuple(mesh.shape) == (16, 16)
        assert rules.rules_for_mesh(mesh) is RULES_SINGLE_POD


OPT_ARCHS = ["internlm2-1.8b", "grok-1-314b", "xlstm-350m", "whisper-base"]


@pytest.mark.parametrize("opt_name", ["adamw", "sgdm", "adafactor"])
def test_optimizer_state_axes_equal_the_reference(opt_name):
    for arch in OPT_ARCHS:
        jm = jmodel.build_model(JSMOKES[arch])
        want = jstate.optimizer_state_axes(opt_name, jm.param_axes(),
                                           jm.abstract_params())
        with cells.fake_mode():
            m = tmodel.build_model(SMOKES[arch], device="cpu")
        got = state.optimizer_state_axes(opt_name, m.param_axes())
        if opt_name != "adafactor":
            # elementwise states mirror the port's per-layer tree
            got = {k: (state.stack_axes(v) if k != "count" else v)
                   for k, v in got.items()}
        assert got == want, (arch, opt_name)
        # and they fit the port optimizer's own state, leaf for leaf
        opt = {"adamw": topt.adamw, "sgdm": topt.sgdm,
               "adafactor": topt.adafactor}[opt_name]()
        with cells.fake_mode():
            st = opt.init(m.param_tree())
        sh = state.axes_to_shardings(
            state.optimizer_state_axes(opt_name, m.param_axes()), st,
            {"data": 2, "model": 2})
        assert sh is not None


def test_train_state_axes_and_batch_axes():
    jm = jmodel.build_model(JSMOKES["internlm2-1.8b"])
    with cells.fake_mode():
        m = tmodel.build_model(SMOKES["internlm2-1.8b"], device="cpu")
    opt = topt.adamw()
    with cells.fake_mode():
        st = tstep.make_train_state_init(m, opt)(
            torch.Generator().manual_seed(0))
    ts = state.train_state_axes(m, opt, st)
    assert ts.opt_state == {"mu": ts.params, "nu": ts.params, "count": ()}
    sh = state.axes_to_shardings(ts, st, {"data": 2, "model": 2})
    assert sh.step.spec == P()
    assert ts.step == ()
    assert state.stack_axes(ts.params) == jm.param_axes()
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "vision_embeds": np.zeros((8, 4, 32), np.float32)}
    assert state.batch_axes(batch) == jstate.batch_axes(batch)
    assert state.replicated({"data": 2}).spec == P()


def test_model_outputs_equal_with_and_without_the_constraints(tmp_path):
    """internlm2 smoke on a gloo world of one: the loss with its weights
    and batch as DTensors under set_active(mesh) (every constraint and
    weight gather redistributes) equals the plain model's."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = SMOKES["internlm2-1.8b"]
    g = torch.Generator().manual_seed(0)
    plain = tmodel.build_model(cfg, device="cpu", generator=g)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    with torch.no_grad():
        want, _ = plain.loss(batch)
    with world_of_one("cpu", tmp_path):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        sharded = tmodel.build_model(cfg, device="cpu",
                                     params=plain.param_tree())
        cells._shard_params(sharded, state.axes_to_shardings(
            sharded.param_axes(), sharded.param_tree(), mesh))
        bsh = state.axes_to_shardings(state.batch_axes(batch), batch, mesh)
        dbatch = state.distribute_tree(batch, bsh)
        with torch.no_grad(), implicit_replication(), \
                rules.set_active(mesh):
            got, _ = sharded.loss(dbatch)
        got = got.full_tensor()
        # without an active mesh every constraint is the identity
        with torch.no_grad(), rules.no_sharding():
            assert rules.get_active() == (None, None)
            same, _ = plain.loss(batch)
    assert not dist.is_initialized()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    assert torch.equal(same, want)


TWO_RANK_WORKER = r"""
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.registry import SMOKES
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as tmodel
from repro_torch.sharding import rules, state

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
torch.set_num_threads(1)
cfg = SMOKES["internlm2-1.8b"]
CASES = [tuple(c) for c in pickle.loads(bytes.fromhex(sys.argv[5]))]
MAX_LEN = int(sys.argv[6])
mesh = make_mesh((1, world), ("data", "model"), device_type="cpu")


def put(x, axes):
    return state.distribute_tree(x, state.axes_to_shardings(axes, x, mesh))


def run(model, prompt, steps, sharded):
    m = cells._NoGradSteps(model) if sharded else model
    tokens = torch.from_numpy(prompt)
    batch = {"tokens": put(tokens, ("batch", None)) if sharded else tokens}
    logits, caches = m.prefill(batch, max_len=MAX_LEN)
    outs = [logits]
    for i, tok in enumerate(steps):
        t = torch.from_numpy(tok)
        logits, caches = m.decode_step(put(t, ("batch", None)) if sharded
                                       else t, caches, prompt.shape[1] + i)
        outs.append(logits)
    return [o.full_tensor() if isinstance(o, DTensor) else o for o in outs]


plain = tmodel.build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
sharded = tmodel.build_model(cfg, device="cpu", params=plain.param_tree())
cells._shard_params(sharded, state.axes_to_shardings(
    sharded.param_axes(), sharded.param_tree(), mesh))
rng = np.random.default_rng(0)
res = {}
for s0, n in CASES:
    prompt = rng.integers(0, cfg.vocab, (2, s0)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(n)]
    with torch.no_grad():
        want = run(plain, prompt, steps, False)
    with implicit_replication(), rules.set_active(mesh):
        got = run(sharded, prompt, steps, True)
        spec = tuple(sharded.init_caches(2, MAX_LEN)["k"].placements)
    res[(s0, n)] = ([w.numpy() for w in want], [g.numpy() for g in got],
                    repr(spec))
pickle.dump(res, open(out, "wb"))
dist.destroy_process_group()
"""


def test_sharded_prefill_and_decode_equal_the_plain_model(tmp_path):
    """internlm2 smoke on a gloo world of two ranks, mesh (1, 2) over
    ("data", "model"): weights sharded by the rules, the KV caches
    sequence-sharded over 'model' (12 positions, 6 a rank). Prefill of 5
    tokens seeds positions 0-4 on rank 0, its 3 decode steps write 5 on
    rank 0 and 6, 7 on rank 1; prefill of 7 seeds both shards, of 12
    the whole cache (each rank its own shard of the value). Every
    logit of both ranks equals the plain model's at f32 rtol / atol 1e-5
    (the sharded products sum in another order)."""
    import pickle
    import subprocess
    import sys

    cases, max_len, world = [(5, 3), (7, 2), (12, 0)], 12, 2
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, logs = [], []
    for r in range(world):
        logs.append(open(tmp_path / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TWO_RANK_WORKER, str(r), str(world),
             str(tmp_path / "store"), str(tmp_path / f"rank{r}.pkl"),
             pickle.dumps(cases).hex(), str(max_len)],
            stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    assert not any(rcs), "\n".join(
        (tmp_path / f"rank{r}.log").read_text()[-3000:] for r in range(world))
    for r in range(world):
        res = pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
        for case in cases:
            want, got, spec = res[case]
            assert spec == "(Shard(dim=1), Shard(dim=2))", spec
            assert len(got) == case[1] + 1
            for i, (w, g) in enumerate(zip(want, got)):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                           err_msg=f"rank {r} {case} {i}")


def test_fake_world_refuses_a_live_group_and_leaks_none(tmp_path):
    with world_of_one("cpu", tmp_path):
        with pytest.raises(RuntimeError, match="already"):
            with fake_world(4):
                pass
        assert dist.get_backend() == "gloo"
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_world(8):
            make_production_mesh()      # 256 ranks on a world of 8
    assert not dist.is_initialized()
