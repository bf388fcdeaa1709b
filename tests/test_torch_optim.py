"""The port's optimizers, schedules and gradient compression
(`repro_torch.optim`, `repro_torch.utils`) against the reference's
(`repro.optim`, `repro.utils`) on the CPU.

Each optimizer gets the same params, grads and state as the reference's
over 3 updates, on a tree with the reference's stacked layer leaves (the
port holds them as a list of per-layer trees): AdamW and SGDM are
elementwise, Adafactor takes its statistics over the stacked leaves, a
1-D per-layer leaf included (factored, with one `vc` shared by the
layers). Then clipping, the schedules, the int8 helpers, error feedback
and `allreduce_compressed` in a gloo world of 2 against the reference's
`psum` over a vmapped axis, and the tree utilities.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.utils import tree as jtree  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.utils import timing, tree  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
L = 3
# f32 elementwise arithmetic in the same order; XLA and torch may round a
# pow, sqrt or rsqrt (and a mean's sum order) 1 ulp apart
RTOL, ATOL = 2e-6, 1e-9
STEPS = 3


def _ref_tree(rng, dtype=np.float32):
    """A model-shaped tree in the reference's layout: layer leaves stacked
    (L, ...), among them a 1-D per-layer leaf ((L, d) stacked) and a 2-D
    one ((L, d, f)), plus unstacked 2-D and 1-D leaves."""
    def a(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(dtype)
    return {"embed": {"table": a(11, 6)},
            "final_norm": {"scale": a(6)},
            "layers": {"attn": {"wq": {"w": a(L, 6, 8)}},
                       "ln1": {"scale": a(L, 6)}},
            "unembed": {"w": a(6, 11)}}


def _port_tree(ref, dtype=torch.float32):
    """The same tree in the port's layout, as tensors."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)

    def per_layer(sub, l):
        return {k: per_layer(v, l) if isinstance(v, dict) else t(v[l])
                for k, v in sub.items()}
    out = {k: jax.tree.map(t, v) for k, v in ref.items() if k != "layers"}
    out["layers"] = [per_layer(ref["layers"], l) for l in range(L)]
    return out


def _stacked(port):
    """The port's tree back in the reference's layout, as f32 numpy."""
    return jax.tree.map(lambda x: x.float().numpy().copy(),
                        optimizers.stack_layers(port))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol)


OPTS = {
    "adamw": (lambda m: m.adamw(), 1e-2),
    "adamw_wd0": (lambda m: m.adamw(weight_decay=0.0, b2=0.999), 3e-2),
    "adafactor": (lambda m: m.adafactor(), 1e-2),
    "adafactor_momentum": (lambda m: m.adafactor(momentum=0.9,
                                                 weight_decay=0.01), 1e-2),
    "sgdm": (lambda m: m.sgdm(), 1e-2),
    "sgdm_0": (lambda m: m.sgdm(momentum=0.0), 1e-2),
}


def _port_state_as_ref(name, state):
    """The port's optimizer state in the reference's layout (numpy)."""
    if "adafactor" in name:
        return jax.tree.map(lambda x: x.float().numpy().copy(), state)
    return {k: (_stacked(v) if k != "count" else v.numpy().copy())
            for k, v in state.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference_on_stacked_leaves(name, dtype):
    make, lr = OPTS[name]
    rng = np.random.default_rng(0)
    ref_params = _ref_tree(rng)
    jp = jax.tree.map(lambda x: jnp.asarray(x, dtype), ref_params)
    tp = _port_tree(jax.tree.map(np.asarray, jp), getattr(torch, dtype))
    jopt, topt = make(joptim), make(optim)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    _close(_port_state_as_ref(name, tstate), jstate, 0, 0)
    # bf16 params round each update once: the reference's and the port's
    # f32 updates may sit on either side of a bf16 rounding boundary (one
    # bf16 ulp, 2^-8 relative)
    bar = (RTOL, ATOL) if dtype == "float32" else (4e-3, 1e-6)
    for step in range(STEPS):
        g = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                         _ref_tree(np.random.default_rng(step + 1)))
        tg = _port_tree(jax.tree.map(np.asarray, g), getattr(torch, dtype))
        jlr = jnp.asarray(lr, jnp.float32)
        ju, jstate = jopt.update(g, jstate, jp, jlr)
        tu, tstate = topt.update(tg, tstate, tp, torch.tensor(lr))
        _close(_stacked(tu), ju, *bar)
        _close(_port_state_as_ref(name, tstate), jstate, *bar)
        jp = joptim.apply_updates(jp, ju)
        tp = optim.apply_updates(tp, tu)
        _close(_stacked(tp), jp, *bar)


def test_adafactor_state_is_the_references_stacked_layout():
    rng = np.random.default_rng(0)
    ref = _ref_tree(rng)
    jst = joptim.adafactor(momentum=0.9).init(jax.tree.map(jnp.asarray, ref))
    tst = optim.adafactor(momentum=0.9).init(_port_tree(ref))
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tst)
    want = jax.tree.map(lambda x: (tuple(x.shape),
                                   "torch." + jnp.dtype(x.dtype).name), jst)
    assert got == want
    # a per-layer 1-D leaf is factored: vr (L,), vc (d,) shared by layers
    assert got["f"]["layers"]["ln1"]["scale"]["vr"][0] == (L,)
    assert got["f"]["layers"]["ln1"]["scale"]["vc"][0] == (6,)


def test_adafactor_per_layer_statistics_would_differ():
    """The trap the stacking avoids: the reference's Adafactor applied to
    each layer's leaves separately (the port's layout taken literally)
    gives another update from the first step."""
    rng = np.random.default_rng(0)
    ref = _ref_tree(rng)
    g = _ref_tree(np.random.default_rng(1))
    opt = joptim.adafactor()
    stacked, _ = opt.update(g, opt.init(ref), ref, 1e-2)
    layer0 = {k: jax.tree.map(lambda x: x[0], v) if k == "layers" else v
              for k, v in ref.items()}
    g0 = {k: jax.tree.map(lambda x: x[0], v) if k == "layers" else v
          for k, v in g.items()}
    alone, _ = opt.update(g0, opt.init(layer0), layer0, 1e-2)
    for path in (("ln1", "scale"), ("attn", "wq", "w")):
        a, b = stacked["layers"], alone["layers"]
        for k in path:
            a, b = a[k], b[k]
        assert np.max(np.abs(np.asarray(a[0]) - np.asarray(b))) > 1e-4


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    ref = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                       _ref_tree(np.random.default_rng(2)))
    tg = _port_tree(jax.tree.map(np.asarray, ref), getattr(torch, dtype))
    jc, jn = joptim.clip_by_global_norm(ref, max_norm)
    tc, tn = optim.clip_by_global_norm(tg, max_norm)
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert all(x.dtype == getattr(torch, dtype)
               for x in tree.tree_leaves(tc))
    bar = (1e-6, 0) if dtype == "float32" else (4e-3, 0)
    _close(_stacked(tc), jc, *bar)


def test_clip_reference_example():
    grads = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, gnorm = optim.clip_by_global_norm(grads, 1.0)
    assert abs(float(gnorm) - 10.0) < 1e-5
    assert abs(float(tree.tree_norm(clipped)) - 1.0) < 1e-5


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_schedules_match_reference(step):
    for kw in ({"peak": 1.0, "warmup_steps": 10, "total_steps": 100},
               {"peak": 3e-3, "warmup_steps": 2, "total_steps": 12},
               {"peak": 3e-4, "warmup_steps": 0, "total_steps": 0,
                "floor": 0.0}):
        want = joptim.warmup_cosine(**kw)(step)
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = optim.warmup_cosine(**kw)(s)
            assert got.dtype == torch.float32 and got.ndim == 0
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-12)
    got = optim.constant(2.5e-4)(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(joptim.constant(2.5e-4)(step))


def test_warmup_cosine_reference_example():
    sch = optim.warmup_cosine(peak=1.0, warmup_steps=10, total_steps=100)
    assert float(sch(0)) == 0.0
    assert abs(float(sch(10)) - 1.0) < 1e-6
    assert float(sch(5)) == pytest.approx(0.5)
    assert float(sch(100)) == pytest.approx(0.1, abs=1e-3)
    assert float(sch(50)) < float(sch(20))


def _vec(seed, n=257, scale=1.0):
    x = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)
    return x * np.float32(scale)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_int8_compression_matches_reference(scale):
    x = _vec(3, scale=scale)
    x[:4] = [0.0, 127.0 * scale / 2, -127.0 * scale / 2, x.max() * 0.5]
    jq, js = joptim.compress_int8(jnp.asarray(x))
    tq, ts = optim.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    back = optim.decompress_int8(tq, ts)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(joptim.decompress_int8(jq, js)))
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        float(ts) / 2 + 1e-7 * scale


def test_round_half_to_even_as_the_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 127.0],
                 np.float32)
    jq, _ = joptim.compress_int8(jnp.asarray(x))
    tq, _ = optim.compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_error_feedback_matches_reference():
    seq = [{"w": _vec(10 + i, 64, 1e-3), "b": _vec(50 + i, 5)}
           for i in range(20)]
    jst = joptim.init_error_feedback(jax.tree.map(jnp.asarray, seq[0]))
    tst = optim.init_error_feedback(jax.tree.map(torch.from_numpy, seq[0]))
    assert isinstance(tst, optim.ErrorFeedbackState)
    for g in seq:
        jqz, jst = joptim.error_feedback_compress(
            jax.tree.map(jnp.asarray, g), jst)
        tqz, tst = optim.error_feedback_compress(
            jax.tree.map(torch.from_numpy, g), tst)
        for k in g:
            np.testing.assert_array_equal(tqz[k][0].numpy(),
                                          np.asarray(jqz[k][0]))
            assert float(tqz[k][1]) == float(jqz[k][1])
            np.testing.assert_array_equal(tst.residual[k].numpy(),
                                          np.asarray(jst.residual[k]))


def test_error_feedback_accumulates_residual():
    """Sum of decompressed updates converges to the true sum (EF-SGD)."""
    grads = [{"w": torch.from_numpy(_vec(100 + i, 64, 1e-3))}
             for i in range(50)]
    state = optim.init_error_feedback(grads[0])
    sent = torch.zeros(64)
    true = torch.zeros(64)
    for g in grads:
        quantized, state = optim.error_feedback_compress(g, state)
        q, s = quantized["w"]
        sent += optim.decompress_int8(q, s)
        true += g["w"]
    gap = (sent + state.residual["w"] - true).abs().max()
    assert float(gap) < 1e-5


WORKER = r'''
import pickle, sys
import torch
import torch.distributed as dist
from repro_torch import optim
rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{store}",
                        rank=rank, world_size=world)
try:
    steps = pickle.load(open(inp, "rb"))
    state = optim.init_error_feedback(
        {k: torch.from_numpy(v[rank]) for k, v in steps[0].items()})
    res = []
    for g in steps:
        mine = {k: torch.from_numpy(v[rank]) for k, v in g.items()}
        mean, state = optim.allreduce_compressed(mine, state)
        res.append(({k: v.numpy() for k, v in mean.items()},
                    {k: v.numpy() for k, v in state.residual.items()}))
    pickle.dump(res, open(out, "wb"))
finally:
    dist.destroy_process_group()
'''


def test_allreduce_compressed_matches_reference_in_a_gloo_world(tmp_path):
    world = 2
    steps = [{"w": np.stack([_vec(200 + 10 * i + r, 40) for r in
                             range(world)]),
              "b": np.stack([_vec(300 + 10 * i + r, 3, 1e-2) for r in
                             range(world)])} for i in range(3)]
    inp = tmp_path / "steps.pkl"
    pickle.dump(steps, open(inp, "wb"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world),
         str(tmp_path / "store"), str(inp), str(tmp_path / f"r{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    got = [pickle.load(open(tmp_path / f"r{r}.pkl", "rb"))
           for r in range(world)]

    # the reference's psum over a vmapped axis of the world's size
    def ref_step(g, r):
        return joptim.allreduce_compressed(
            g, joptim.ErrorFeedbackState(residual=r), "pod")
    fn = jax.vmap(ref_step, axis_name="pod")
    res = jax.tree.map(lambda v: jnp.zeros(v.shape, jnp.float32), steps[0])
    for i, g in enumerate(steps):
        mean, st = fn(jax.tree.map(jnp.asarray, g), res)
        res = st.residual
        for r in range(world):
            for k in g:
                np.testing.assert_allclose(got[r][i][0][k],
                                           np.asarray(mean[k][r]),
                                           rtol=1e-6, atol=0)
                np.testing.assert_array_equal(got[r][i][1][k],
                                              np.asarray(st.residual[k][r]))


def test_tree_utilities_match_reference():
    ref = _ref_tree(np.random.default_rng(4))
    port = _port_tree(ref)
    jt = jax.tree.map(jnp.asarray, ref)
    assert tree.tree_count(port) == jtree.tree_count(jt)
    assert tree.tree_bytes(port) == jtree.tree_bytes(jt)
    assert tree.tree_bytes(tree.tree_cast(port, torch.bfloat16)) == \
        jtree.tree_bytes(jtree.tree_cast(jt, jnp.bfloat16))
    np.testing.assert_allclose(float(tree.tree_norm(port)),
                               float(jtree.tree_norm(jt)), rtol=1e-6)
    z = tree.tree_zeros_like(port)
    assert all(float(x.abs().sum()) == 0 for x in tree.tree_leaves(z))
    mixed = {"a": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)}
    cast = tree.tree_cast(mixed, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16
    assert cast["i"].dtype == torch.int32


def test_tree_order_and_unflatten():
    """Leaves in jax.tree_util's order (dict keys sorted, sequences and
    dataclass fields by index); unflatten rebuilds the template's kinds,
    named tuples included."""
    import dataclasses
    from typing import NamedTuple

    @dataclasses.dataclass
    class DC:
        x: object
        y: object

    class NT(NamedTuple):
        a: object
        b: object

    t = {"z": [1, (2, 3)], "a": DC(x=4, y=None), "m": NT(a=5, b={"q": 6})}
    paths = tree.leaves_with_paths(t)
    assert [leaf for _, leaf in paths] == [4, 5, 6, 1, 2, 3]
    assert paths[0][0] == ("a", 0)
    back = tree.unflatten(t, [10 * x for _, x in paths])
    assert back["a"] == DC(x=40, y=None)
    assert back["m"] == NT(a=50, b={"q": 60})
    assert back["z"] == [10, (20, 30)]
    assert tree.tree_map(lambda a, b: a + b, t, back)["m"].b["q"] == 66


def test_time_fn_summarizes_repeats():
    calls = []
    st = timing.time_fn(lambda: calls.append(1) or torch.ones(2), iters=5,
                        warmup=2, trim=1)
    assert len(calls) == 7 and st.n == 3 and st.trimmed == 1
    assert st.min <= st.median and float(st) == st.median
    with pytest.raises(ValueError):
        timing.time_fn(lambda: None, iters=2, trim=1)
    with timing.Timer() as t:
        pass
    assert t.elapsed >= 0.0


@pytest.mark.parametrize("make_opt,lr", [
    (optim.adamw, 0.05),
    (optim.adafactor, 0.5),
    (optim.sgdm, 0.02),
])
def test_optimizer_descends(make_opt, lr):
    rng = np.random.default_rng(0)
    target = {"a": torch.from_numpy(rng.normal(size=(8, 4)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(4,)).astype(
            np.float32))}
    params = tree.tree_map(torch.zeros_like, target)
    opt = make_opt()
    state = opt.init(params)

    def loss_of(p):
        return sum(torch.sum((x - t) ** 2) for x, t in
                   zip(tree.tree_leaves(p), tree.tree_leaves(target)))

    l0 = float(loss_of(params))
    for _ in range(60):
        grads = tree.tree_map(lambda x, t: 2 * (x - t), params, target)
        updates, state = opt.update(grads, state, params, lr)
        params = optim.apply_updates(params, updates)
    assert float(loss_of(params)) < 0.2 * l0, opt.name
