"""The port's mesh execution of the pipeline and the many-study entry
points against the reference's, on gloo worlds of two and four ranks.

pipeline(mesh=) runs the sharded fused-kernel sweep
(streaming.fused_sw_sharded) over (2, 2), (4, 1) and (1, 4) with a ragged
row block and chunk: every rank returns the same result; it matches the
reference's single-host pipeline on the reference's draws (F at rtol
1e-4, p equal); with 'model' = 1 it is the port's single-host
fused-kernel bridge (fused_impl='cuda') bit for bit, with rows sharded it
meets the reference's bar and gives the same bits on a second run.
pipeline_many(mesh=) and permanova_many(mesh=), labels and designs, shard
S = 3 studies over 'data' on two and four ranks (wrap-padded, '+pad1'):
each equals the serial run bit for bit and the reference's batch at its
bar. Then the refusals, which the port shares with the reference, and a
one-rank world in this process.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache (the reference's conftest turns its
# own off); tests of the cache point it at files of their own.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro import pipeline as jpipe  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro_torch import engine, pipeline  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

from test_torch_distributed import (RTOL, assert_ranks_agree,  # noqa: E402
                                    assert_reference_bar, run_world)

N, D, G = 90, 12, 3
PERMS = 39
N_TOTAL = PERMS + 1
ROW_BLOCK = 17           # 90 rows: shards of 51 + 39, or 34 x 2 + 22 + 0
CHUNK = 7                # a ragged last chunk in every window
S = 3                    # studies: wrap-padded to 4 on 2 or 4 ranks
NS = 40                  # a study's samples
KEY = jax.random.key(5)
AXES = ("data", "model")


def _study(seed=2, n=N):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, D)).astype(np.float32)
    x *= rng.random(size=(n, D)) < 0.7
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    grouping = rng.integers(0, G, size=n).astype(np.int32)
    grouping[:G] = np.arange(G)
    x[grouping == 1, 1] += 1.0
    return x, grouping


def _labels(grouping, key=KEY, n_total=N_TOTAL):
    return np.array(jperm.permutation_batch(key, jnp.asarray(grouping), 0,
                                            n_total))


def _many():
    studies = [_study(10 + s, NS) for s in range(S)]
    xs = np.stack([st[0] for st in studies])
    gs = np.stack([st[1] for st in studies])
    perms = np.stack([_labels(gs[s], jax.random.fold_in(KEY, s))
                      for s in range(S)])
    cov = np.random.default_rng(3).normal(size=(S, NS, 2))
    index_perms = np.stack([np.array(jperm.strata_permutation_batch(
        jax.random.fold_in(KEY, s), jnp.zeros((NS,), jnp.int32), 0,
        N_TOTAL)) for s in range(S)])
    return xs, gs, perms, cov, index_perms


def _dms(xs):
    dense = jpipe.get("braycurtis.blocked").bound()[2]
    return np.stack([np.array(dense(jnp.asarray(x))) for x in xs])


PIPE_MESHES = [(2, 2), (4, 1), (1, 4)]
MANY = [(fn, kind) for fn in ("pipeline_many", "permanova_many")
        for kind in ("labels", "design")]


def _pipe_id(shape, impl="cuda"):
    return f"pipe-{'x'.join(map(str, shape))}-{impl}"


def _many_id(world, fn, kind):
    return f"{fn}-{kind}-{world}"


def _many_case(world, fn, kind):
    xs, gs, perms, cov, index_perms = _many()
    data = xs if fn == "pipeline_many" else _dms(xs)
    kw = dict(n_groups=G, n_perms=PERMS)
    if kind == "labels":
        kw["perms"] = perms
    else:
        kw.update(covariates=cov, index_perms=index_perms)
    if fn == "pipeline_many":
        kw["materialize"] = "fused-kernel"
    return dict(id=_many_id(world, fn, kind), fn=fn, shape=(world, 1),
                axes=AXES, args=[data, gs], kw=kw, single={}, observe=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """A world of four ranks for the pipeline meshes and the four-way
    study axis, a world of two for the two-way study axis."""
    x, grouping = _study()
    labels = _labels(grouping)
    pipe_kw = dict(n_groups=G, n_perms=PERMS, perms=labels,
                   row_block=ROW_BLOCK, chunk=CHUNK)
    cases = [dict(id=_pipe_id(shape), fn="pipeline", shape=shape, axes=AXES,
                  args=[x, grouping], kw=pipe_kw, repeat=2,
                  single=dict(materialize="fused-kernel", fused_impl="cuda"))
             for shape in PIPE_MESHES]
    cases.append(dict(id=_pipe_id((2, 2), "torch"), fn="pipeline",
                      shape=(2, 2), axes=AXES, args=[x, grouping],
                      kw=dict(pipe_kw, fused_impl="torch"), repeat=2,
                      single=dict(materialize="fused-kernel")))
    cases += [_many_case(4, fn, kind) for fn, kind in MANY]
    out = run_world(tmp_path_factory.mktemp("world4"), 4, cases)
    out.update(run_world(tmp_path_factory.mktemp("world2"), 2,
                         [_many_case(2, fn, kind) for fn, kind in MANY]))
    return out


@pytest.mark.parametrize("shape", PIPE_MESHES,
                         ids=["x".join(map(str, s)) for s in PIPE_MESHES])
def test_pipeline_mesh(worlds, shape):
    per_rank = worlds[_pipe_id(shape)]
    assert_ranks_agree(per_rank)
    got, again = per_rank[0]["runs"]
    single = per_rank[0]["single"]
    np.testing.assert_array_equal(got["f_perms"], again["f_perms"])
    assert ":: cuda+mesh rows=64 " in got["plan"]
    perm_ways = shape[0]
    assert f"chunks={-(-N_TOTAL // (CHUNK * perm_ways)) * perm_ways}" \
        in got["plan"]
    x, grouping = _study()
    ref = jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping),
                         n_perms=PERMS, key=KEY, n_groups=G,
                         materialize="fused-kernel", row_block=ROW_BLOCK,
                         chunk=CHUNK)
    np.testing.assert_allclose(got["f_stat"], float(ref.f_stat), rtol=RTOL)
    assert float(got["p_value"]) == float(ref.p_value)
    if shape[1] == 1:
        np.testing.assert_array_equal(got["f_perms"], single["f_perms"])
        assert float(got["s_t"]) == float(single["s_t"])
    else:
        assert_reference_bar(got["f_perms"], single["f_perms"],
                             got["p_value"], single["p_value"], N, G)


def test_pipeline_mesh_with_the_torch_sweep_pinned(worlds):
    """fused_impl='torch' runs the slabs' one-hot contraction per rank:
    the reference's bar against the single-host torch sweep, and the same
    bits on a second run."""
    per_rank = worlds[_pipe_id((2, 2), "torch")]
    assert_ranks_agree(per_rank)
    got, again = per_rank[0]["runs"]
    single = per_rank[0]["single"]
    np.testing.assert_array_equal(got["f_perms"], again["f_perms"])
    assert ":: torch+mesh rows=17 " in got["plan"]
    assert_reference_bar(got["f_perms"], single["f_perms"], got["p_value"],
                         single["p_value"], N, G)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn,kind", MANY)
def test_many_over_the_study_axis(worlds, world, fn, kind):
    per_rank = worlds[_many_id(world, fn, kind)]
    assert_ranks_agree(per_rank)
    got = per_rank[0]["runs"][0]
    single = per_rank[0]["single"]
    assert got["f_perms"].shape == (S, N_TOTAL)
    np.testing.assert_array_equal(got["f_perms"], single["f_perms"])
    np.testing.assert_array_equal(got["p_value"], single["p_value"])
    for t, u in zip(got["terms"], single["terms"]):
        np.testing.assert_array_equal(t["f_perms"], u["f_perms"])
    assert f" [studies@data[{world}]+pad1]" in got["plan"]
    assert got["plan"].replace(f"studies@data[{world}]+pad1",
                               "in turn") == single["plan"]
    xs, gs, _, cov, _ = _many()
    kw = dict(n_groups=G, n_perms=PERMS, key=KEY)
    if kind == "design":
        kw["covariates"] = cov
    if fn == "pipeline_many":
        ref = jpipe.pipeline_many(jnp.asarray(xs), jnp.asarray(gs),
                                  materialize="fused-kernel", **kw)
    else:
        ref = jengine.permanova_many(jnp.asarray(_dms(xs)), jnp.asarray(gs),
                                     **kw)
    np.testing.assert_allclose(got["f_stat"], np.asarray(ref.f_stat),
                               rtol=RTOL)
    np.testing.assert_array_equal(np.asarray(got["p_value"], np.float64),
                                  np.asarray(ref.p_value, np.float64))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn,kind", MANY)
def test_many_ranks_count_only_their_own_studies(worlds, world, fn, kind):
    """A rank's telemetry is its block's: the ranks' `engine.studies`
    counters sum to S (a padded replay is not counted), and a rank's
    `engine.studies` span holds its block's studies (the replay included,
    since the rank ran it) and their predicted bytes, the single-host
    batch's share (every study plans alike on the CPU)."""
    per_rank = worlds[_many_id(world, fn, kind)]
    single = per_rank[0]["single_obs"]
    assert single["studies"] == S
    assert sum(r["obs"]["studies"] for r in per_rank) == S
    block = (S + (-S) % world) // world
    if fn == "pipeline_many":       # the fused-kernel bridge: no span
        assert all(not r["obs"]["spans"] for r in per_rank)
        return
    (n_single, bytes_single), = single["spans"]
    assert n_single == S and bytes_single > 0
    for r in per_rank:
        (n_rank, bytes_rank), = r["obs"]["spans"]
        assert n_rank == block
        np.testing.assert_allclose(bytes_rank, bytes_single * block / S,
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# Refusals, and a one-rank world in this process.
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh(tmp_path):
    with pmesh.world_of_one("cpu", tmp_path):
        yield pmesh.make_mesh((1, 1), AXES, device_type="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("what", ["covariates", "strata", "weights"])
def test_a_design_with_a_mesh_is_refused_as_the_reference_does(
        what, one_rank_mesh):
    x, grouping = _study()
    design = {"covariates": {"age": np.zeros(N)},
              "strata": np.arange(N) % 2, "weights": np.ones(N)}
    with pytest.raises(ValueError, match="plain single-factor") as port:
        pipeline.pipeline(torch.from_numpy(x), torch.from_numpy(grouping),
                          n_perms=9, mesh=one_rank_mesh, device="cpu",
                          **{what: design[what]})
    with pytest.raises(ValueError) as ref:
        jpipe.pipeline(jnp.asarray(x), jnp.asarray(grouping), n_perms=9,
                       mesh=object(), **{what: design[what]})
    assert str(port.value) == str(ref.value)


def test_mesh_refusals_and_a_one_rank_world(one_rank_mesh):
    x, grouping = _study()
    xt, gt = torch.from_numpy(x), torch.from_numpy(grouping)
    with pytest.raises(ValueError, match="fused-kernel only"):
        pipeline.pipeline(xt, gt, n_perms=9, materialize="dense",
                          mesh=one_rank_mesh, device="cpu")
    xs, gs, *_ = _many()
    with pytest.raises(ValueError, match="fused-kernel only"):
        pipeline.pipeline_many(xs, gs, n_groups=G, n_perms=9,
                               materialize="dense", mesh=one_rank_mesh,
                               device="cpu")
    with pytest.raises(ValueError, match="index_perms"):
        pipeline.pipeline(xt, gt, n_perms=9, mesh=one_rank_mesh,
                          index_perms=torch.zeros((10, N), dtype=torch.int32),
                          device="cpu")
    res = pipeline.pipeline(xt, gt, n_perms=9, mesh=one_rank_mesh,
                            device="cpu", row_block=ROW_BLOCK, chunk=CHUNK)
    one = pipeline.pipeline(xt, gt, n_perms=9, materialize="fused-kernel",
                            fused_impl="cuda", device="cpu",
                            row_block=ROW_BLOCK, chunk=CHUNK)
    assert torch.equal(res.f_perms, one.f_perms) and "+mesh" in res.plan
    many = engine.permanova_many(_dms(xs), gs, n_groups=G, n_perms=9,
                                 mesh=one_rank_mesh, device="cpu")
    assert many.plan.endswith("[in turn]") and len(many) == S
