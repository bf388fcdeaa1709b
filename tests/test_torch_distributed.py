"""The port's multi-device PERMANOVA (repro_torch.core.distributed and
launch.mesh) against the reference's (repro.core.distributed).

First the row partials and the registry's sharded companions on the same
row slabs as the reference's, and brute's band partials (the kernel's
row-slab entry's plain version). Then permanova_distributed on gloo
worlds of four ranks over meshes (4, 1), (2, 2), (1, 4) and (pod, data,
model) = (2, 1, 2), for brute and matmul: every rank returns the same
result; each matches the reference's single-host permanova on the
reference's draws (F at rtol 1e-4, p equal); permutation-only sharding
('model' = 1) equals the port's single-host run (a (1, 1) mesh in a
world of one) bit for bit;
row sharding meets the reference's bar (F rtol 1e-4, p equal, each null F
within 2e-6 (F + (n - G)/(G - 1))) and gives the same bits on a second
run. The reference's side is computed here; the ranks are processes of
their own that import only the port (`run_world`). Last, the CLI's
--distributed / --shard-rows argument errors.
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

from repro import engine as jengine  # noqa: E402
from repro.core import fstat as jfstat  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import distributed, fstat  # noqa: E402
from repro_torch.kernels.permanova_sw import ops  # noqa: E402
from repro_torch.launch import permanova as cli  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
N, D, G = 200, 16, 4     # 200 rows: 2 shards of 128 + 72, or 4 of 64 + 8
PERMS = 39               # 40 draws: whole blocks on 1, 2 and 4 ways
N_TOTAL = PERMS + 1
RTOL = 1e-4
NULL_ALLOWANCE = 2e-6
KEY = jax.random.key(11)
WORLD_TIMEOUT = 180

# ---------------------------------------------------------------------------
# A gloo world of processes that import only the port.
# ---------------------------------------------------------------------------

WORKER = r'''
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, cases_path, out_path = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"file://{store}",
                        world_size=world, rank=rank)
from repro_torch import engine, obs, pipeline
from repro_torch.core import permanova_distributed
from repro_torch.launch import mesh as M

FNS = {"permanova_distributed": permanova_distributed,
       "pipeline": pipeline.pipeline, "pipeline_many": pipeline.pipeline_many,
       "permanova_many": engine.permanova_many}
DESIGN_KEYS = ("covariates", "strata", "weights")


def host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def flat(res):
    out = {k: host(getattr(res, k))
           for k in ("f_stat", "p_value", "f_perms", "s_t", "s_w")}
    out["plan"], out["n_perms"] = res.plan, res.n_perms
    out["terms"] = [{k: host(getattr(t, k))
                     for k in ("f_stat", "p_value", "f_perms")}
                    for t in (res.terms or ())]
    return out


def call(case, mesh):
    fn = FNS[case["fn"]]
    kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
              and k not in DESIGN_KEYS else v)
          for k, v in case["kw"].items()}
    args = [torch.from_numpy(a) for a in case["args"]]
    if case["fn"] == "permanova_distributed":
        return fn(mesh, *args, **kw)
    return fn(*args, mesh=mesh, device="cpu", **kw)


def observed(case, mesh):
    """One run under telemetry: its engine.studies counter and the
    engine.studies spans' studies and predicted bytes."""
    obs.enable(trace=True, metrics=True)
    obs.metrics.reset()
    obs.clear()
    try:
        call(case, mesh)
        return {"studies": obs.metrics.value("engine.studies"),
                "spans": [(e["args"]["studies"], e["args"]["predicted_bytes"])
                          for e in obs.events()
                          if e["name"] == "engine.studies"]}
    finally:
        obs.disable()


def single_mesh(case):
    """The single-host yardstick: permanova_distributed on a (1, 1) mesh
    of a world of one, every other entry point without a mesh."""
    if case["fn"] == "permanova_distributed":
        return M.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    return None


cases = pickle.load(open(cases_path, "rb"))
out = {}
for case in cases:
    mesh = M.make_mesh(case["shape"], case["axes"], device_type="cpu")
    runs = [flat(call(case, mesh)) for _ in range(case.get("repeat", 1))]
    out[case["id"]] = {"runs": runs, "single": None, "obs": None,
                       "single_obs": None}
    if case.get("observe"):
        out[case["id"]]["obs"] = observed(case, mesh)
dist.destroy_process_group()
if rank == 0:       # the single-host runs, in a world of one
    with M.world_of_one("cpu"):
        for case in cases:
            if case.get("single") is None:
                continue
            one = dict(case, kw={**case["kw"], **case["single"]})
            out[case["id"]]["single"] = flat(call(one, single_mesh(case)))
            if case.get("observe"):
                out[case["id"]]["single_obs"] = observed(one, None)
pickle.dump(out, open(out_path, "wb"))
'''


def run_world(tmp_path, world: int, cases, timeout=WORLD_TIMEOUT):
    """Run `cases` on a gloo world of `world` processes (a file store in
    tmp_path: no port to clash under xdist); each case's result on every
    rank, {case id: [rank results]}."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    cases_path = tmp_path / "cases.pkl"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, logs = [], []
    for r in range(world):
        log = open(tmp_path / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world),
             str(tmp_path / "store"), str(cases_path),
             str(tmp_path / f"rank{r}.pkl")],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rcs):
        tails = [(tmp_path / f"rank{r}.log").read_text()[-3000:]
                 for r in range(world)]
        raise AssertionError(f"world of {world} failed {rcs}:\n"
                             + "\n".join(tails))
    outs = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
            for r in range(world)]
    return {c["id"]: [o[c["id"]] for o in outs] for c in cases}


def assert_ranks_agree(per_rank):
    """Every rank returned the same bits."""
    first = per_rank[0]["runs"][0]
    for r in per_rank[1:]:
        np.testing.assert_array_equal(r["runs"][0]["f_perms"],
                                      first["f_perms"])
        assert r["runs"][0]["plan"] == first["plan"]


def assert_reference_bar(f_perms, ref_f_perms, p, ref_p, n, g):
    """The reference's bar: F at rtol 1e-4, p equal, each null F within
    2e-6 (F + (n - G)/(G - 1))."""
    f_perms = np.asarray(f_perms, np.float64)
    ref = np.asarray(ref_f_perms, np.float64)
    np.testing.assert_allclose(f_perms[0], ref[0], rtol=RTOL)
    assert float(p) == float(ref_p)
    tol = NULL_ALLOWANCE * (np.abs(ref) + (n - g) / (g - 1))
    assert np.all(np.abs(f_perms - ref) <= tol), \
        float(np.max(np.abs(f_perms - ref) / tol))


# ---------------------------------------------------------------------------
# Inputs.
# ---------------------------------------------------------------------------

def _study(seed=3, n=N):
    rng = np.random.default_rng(seed)
    x = rng.gamma(1.0, 1.0, size=(n, D)).astype(np.float32)
    x[:, 0] = np.maximum(x[:, 0], 1e-3)
    grouping = rng.integers(0, G, size=n).astype(np.int32)
    grouping[:G] = np.arange(G)
    x[grouping == 1, 1] += 1.0
    num = np.abs(x[:, None, :] - x[None, :, :]).sum(-1)
    den = (x[:, None, :] + x[None, :, :]).sum(-1)
    dm = (num / den).astype(np.float32)
    np.fill_diagonal(dm, 0.0)
    return x, grouping, dm


def _ref_labels(grouping, n_total=N_TOTAL):
    return np.array(jperm.permutation_batch(KEY, jnp.asarray(grouping), 0,
                                            n_total))


# ---------------------------------------------------------------------------
# Row partials.
# ---------------------------------------------------------------------------

SLABS = [(0, N), (0, 128), (128, 72), (64, 64), (37, 50)]


@pytest.mark.parametrize("lo,rows", SLABS)
def test_row_partials_equal_the_reference(lo, rows):
    """sw_rows_partial, sw_matmul_rows_partial and sw_cols_rows_partial
    on the same row slab and draws as the reference's, and the slabs'
    partials summing to the whole statistic."""
    _, grouping, dm = _study()
    mat2 = (dm * dm).astype(np.float32)
    labels = _ref_labels(grouping)[:9]
    inv = np.array(jperm.inv_group_sizes(jnp.asarray(grouping), G))
    slab = mat2[lo:lo + rows]
    tl, tslab, tinv = (torch.from_numpy(labels), torch.from_numpy(slab),
                       torch.from_numpy(inv))
    scale = float(mat2.sum()) / 2
    for port_fn, ref_fn in ((fstat.sw_rows_partial, jfstat.sw_rows_partial),
                            (fstat.sw_matmul_rows_partial,
                             jfstat.sw_matmul_rows_partial)):
        got = port_fn(tslab, lo, tl, tinv).numpy()
        want = np.array(ref_fn(jnp.asarray(slab), jnp.asarray(lo),
                               jnp.asarray(labels), jnp.asarray(inv)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    basis = np.random.default_rng(4).normal(size=(N, 3)).astype(np.float32)
    vperms = basis[labels.argsort(axis=1, kind="stable")]
    got = fstat.sw_cols_rows_partial(tslab, lo, torch.from_numpy(vperms))
    want = np.array(jfstat.sw_cols_rows_partial(
        jnp.asarray(slab), jnp.asarray(lo), jnp.asarray(vperms)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * scale)


def test_band_partials_are_the_whole_matrix_bands():
    """Whole-band slabs' band partials, concatenated in row order, are
    the whole matrix's bands bit for bit (the brute kernel's row-slab
    contract, here its plain version), and a permutation's bands do not
    depend on the chunk; a row offset off the 64-row band raises, and
    CPU calls launch nothing."""
    _, grouping, dm = _study()
    mat2 = torch.from_numpy((dm * dm).astype(np.float32))
    labels = torch.from_numpy(_ref_labels(grouping))
    inv = torch.from_numpy(np.array(jperm.inv_group_sizes(
        jnp.asarray(grouping), G)))
    before = dict(ops.LAUNCHES)
    whole = ops.permanova_sw_rows(mat2, labels, inv, row_offset=0)
    assert whole.shape == (N_TOTAL, -(-N // 64))
    for cut in (64, 128, 192):
        parts = [ops.permanova_sw_rows(mat2[:cut].contiguous(), labels, inv,
                                       row_offset=0),
                 ops.permanova_sw_rows(mat2[cut:].contiguous(), labels, inv,
                                       row_offset=cut)]
        assert torch.equal(torch.cat(parts, dim=1), whole)
    assert torch.equal(ops.permanova_sw_rows(mat2, labels[5:12].contiguous(),
                                             inv, row_offset=0), whole[5:12])
    np.testing.assert_allclose(whole.sum(dim=1).numpy(),
                               fstat.sw_brute(mat2, labels, inv).numpy(),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.permanova_sw_rows(mat2[37:].contiguous(), labels, inv,
                              row_offset=37)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.permanova_sw_rows(mat2[:128].contiguous(), labels, inv,
                              row_offset=128)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("impl", ["brute", "tiled", "matmul"])
def test_slab_widths_are_the_partials_widths(impl):
    """Every rank computes each slab's partial width (registry.
    sharded_width on distributed.row_slab) instead of gathering it: the
    width is the sharded partial's own, and an empty slab has none."""
    _, grouping, dm = _study()
    mat2 = torch.from_numpy((dm * dm).astype(np.float32))
    labels = torch.from_numpy(_ref_labels(grouping)[:3])
    inv = torch.full((G,), 1.0 / 50)
    partial = engine.registry.get_sharded(impl)
    for ways in (1, 2, 3, 4, 5):
        slabs = [distributed.row_slab(N, ways, m) for m in range(ways)]
        assert slabs[0][0] == 0 and slabs[-1][1] == N
        assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
        for r0, r1 in slabs:
            want = engine.registry.sharded_width(impl, r1 - r0)
            if r1 == r0:
                assert want == 0
                continue
            got = partial(mat2[r0:r1].contiguous(), r0, labels, inv)
            assert got.shape == (3, want)


def test_get_sharded_maps_every_impl():
    """brute and tiled (and their pallas_* aliases) run brute's band
    partials, matmul its one-hot partial, as the reference maps them."""
    reg = engine.registry
    brute = reg.get("brute").sharded
    matmul = reg.get("matmul").sharded
    assert brute is not None and matmul is not None
    for name in ("brute", "tiled", "pallas_brute", "pallas_permblock"):
        assert reg.get_sharded(name) is brute
    for name in ("matmul", "pallas_matmul"):
        assert reg.get_sharded(name) is matmul
    _, grouping, dm = _study()
    mat2 = torch.from_numpy((dm * dm).astype(np.float32))
    labels = torch.from_numpy(_ref_labels(grouping)[:5])
    inv = torch.full((G,), 1.0 / 50)
    assert matmul(mat2[64:].contiguous(), 64, labels, inv).shape == (5, 1)
    assert brute(mat2[64:].contiguous(), 64, labels, inv).shape == (5, 3)


def test_helpers_are_the_references():
    x = torch.arange(10.0).reshape(5, 2)
    padded, pad = distributed.pad_to_multiple(x, 4)
    assert pad == 3 and padded.shape == (8, 2) and padded[5:].eq(0).all()
    same, pad = distributed.pad_to_multiple(x, 5)
    assert pad == 0 and same is x
    assert distributed.pad_to_multiple(x, 3, axis=1)[0].shape == (5, 3)
    assert distributed.rows_per_shard(200, 2) == 128
    assert distributed.rows_per_shard(200, 4) == 64
    assert distributed.row_slab(200, 2, 1) == (128, 200)
    assert distributed.row_slab(200, 4, 3) == (192, 200)
    assert distributed.row_slab(10, 4, 1) == (10, 10)     # past n: empty


def test_a_design_is_refused(tmp_path):
    """A world of one with a (1, 1) mesh is the single host: one
    permutation block, the whole matrix; a design is refused as the
    reference refuses it, and a card's mesh raises without a card."""
    _, grouping, dm = _study()
    from repro_torch.core import design
    from repro_torch.launch import mesh as pmesh
    des = design.build(grouping=grouping, strata=np.arange(N) % 2,
                       n_groups=G, device="cpu")
    with pmesh.world_of_one("cpu", tmp_path):
        mesh = pmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        lay = distributed.layout(mesh)
        assert (lay.perm_ways, lay.model_ways, lay.world) == (1, 1, 1)
        assert distributed._my_perm_range(lay, 40) == (0, 40)
        with pytest.raises(ValueError, match="plain single-factor"):
            distributed.permanova_distributed(mesh, dm, des, n_perms=9)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="card"):
                pmesh.make_mesh((1, 1), ("data", "model"))
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# permanova_distributed on gloo worlds of four ranks.
# ---------------------------------------------------------------------------

MESHES = [((4, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")),
          ((2, 1, 2), ("pod", "data", "model"))]
CASES = [(shape, axes, impl) for shape, axes in MESHES
         for impl in ("brute", "matmul")]


def _case_id(shape, impl):
    return f"{'x'.join(map(str, shape))}-{impl}"


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One gloo world of four ranks runs every case (twice each, and the
    single-host run beside it)."""
    _, grouping, dm = _study()
    labels = _ref_labels(grouping)
    cases = [dict(id=_case_id(shape, impl), fn="permanova_distributed",
                  shape=shape, axes=axes, args=[dm, grouping],
                  kw=dict(n_perms=PERMS, perms=labels, impl=impl,
                          n_groups=G, chunk=7),
                  repeat=2, single={})
             for shape, axes, impl in CASES]
    # the permutation count padded up to the ways: 41 draws on 4 ways
    cases.append(dict(id="pad", fn="permanova_distributed", shape=(4, 1),
                      axes=("data", "model"), args=[dm, grouping],
                      kw=dict(n_perms=40, seed=5, impl="brute", n_groups=G),
                      single={}))
    return run_world(tmp_path_factory.mktemp("world4"), 4, cases)


@pytest.mark.parametrize("shape,axes,impl", CASES,
                         ids=[_case_id(s, i) for s, _, i in CASES])
def test_permanova_distributed_on_four_ranks(world4, shape, axes, impl):
    per_rank = world4[_case_id(shape, impl)]
    assert_ranks_agree(per_rank)
    got, again = per_rank[0]["runs"]
    single = per_rank[0]["single"]
    np.testing.assert_array_equal(got["f_perms"], again["f_perms"])
    assert got["n_perms"] == PERMS
    _, grouping, dm = _study()
    ref = jengine.run(jnp.asarray(dm), jnp.asarray(grouping), n_perms=PERMS,
                      key=KEY, n_groups=G, impl=impl)
    np.testing.assert_allclose(got["f_stat"], float(ref.f_stat), rtol=RTOL)
    assert float(got["p_value"]) == float(ref.p_value)
    if shape[-1] == 1:          # 'model' = 1: permutation sharding only
        np.testing.assert_array_equal(got["f_perms"], single["f_perms"])
        assert float(got["s_t"]) == float(single["s_t"])
    else:
        assert_reference_bar(got["f_perms"], single["f_perms"],
                             got["p_value"], single["p_value"], N, G)
    model = shape[-1]
    assert f"rows@model[{model}]" in got["plan"]
    assert got["plan"].startswith(impl)


def test_permutation_count_pads_to_the_ways(world4):
    """41 draws over 4 ways run 44: the first 41 are the single-host
    run's bit for bit, the padding only adds null draws."""
    got = world4["pad"][0]["runs"][0]
    single = world4["pad"][0]["single"]
    assert_ranks_agree(world4["pad"])
    assert got["n_perms"] == 43 and single["n_perms"] == 40
    np.testing.assert_array_equal(got["f_perms"][:41], single["f_perms"])


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,match", [
    (["--distributed", "--from-features"], "--distributed is not supported"),
    (["--shard-rows", "2", "--materialize", "dense"],
     "--shard-rows runs the fused-kernel sweep"),
    (["--shard-rows", "0"], "positive number"),
])
def test_cli_argument_errors(argv, match, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--samples", "48", "--perms", "9", "--device", "cpu"]
                 + argv)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


def test_cli_runs_as_a_world_of_one(capsys):
    """Without torchrun --distributed and --shard-rows run as a world of
    one: the same F and p as the single-host paths."""
    argv = ["--samples", "64", "--perms", "19", "--device", "cpu"]
    assert cli.main(argv + ["--distributed", "--impl", "brute"]) == 0
    dist_out = capsys.readouterr().out
    assert "+distributed" in dist_out and "rows@model[1]" in dist_out
    assert cli.main(argv + ["--impl", "brute"]) == 0
    plain_out = capsys.readouterr().out
    p_line = [ln for ln in plain_out.splitlines() if "F=" in ln][0]
    assert [ln for ln in dist_out.splitlines() if "F=" in ln][0] \
        .split()[-1] == p_line.split()[-1]
    assert cli.main(argv + ["--shard-rows", "1"]) == 0
    assert "+mesh" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
