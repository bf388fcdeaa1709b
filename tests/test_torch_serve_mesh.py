"""The port's multi-device serving (PermanovaServer(mesh=), serve.mesh) on
gloo worlds of processes.

Every rank builds the same server; rank 0 serves coalesced batches whose
study axis is sharded over 'data' while the other ranks follow(). Each
case's results on rank 0 are held to the same server without a mesh, run
in the rank-0 process (one thread, the same bits), bit for bit: label,
strata and dense-design batches on meshes (2, 1), (4, 1) (S = 3,
wrap-padded) and (2, 2), a worker death, a deadline-degraded member and
its resume, background worker threads, and the reference's explicit
draws (also against the reference server: F at rtol 1e-4, p equal). A
block that fails on a follower fails rank 0's batch with the follower's
message, the next batch is served, and the follower's follow() raises at
stop. Each follower receives exactly its block's operands (obs's
serve.mesh.* counters); a follower outlives
an idle gap longer than its group's timeout; stop() ends every
follower, and a follower's admission calls raise. The ranks import only
the port; the reference's side is computed here.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# Plans follow the planner's rules, never a winner persisted in the
# host's default autotune cache; the worlds inherit the setting.
os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE", "off")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import permutations as jperm  # noqa: E402
from repro.serve import permanova as jserve  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.serve.permanova import (PermanovaServer,  # noqa: E402
                                         StudyRequest)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
G = 3
BLOCK = 16
PERMS = 63
RTOL = 1e-4
NULL_RTOL = 2e-6          # PERF.md §2: 2 x SW_MAIN_RTOL
WORLD_TIMEOUT = 240
GROUP_TIMEOUT_S = 3       # world2's process-group timeout
IDLE_S = 5                # the idle gap, longer than the timeout

# ---------------------------------------------------------------------------
# A gloo world of processes that import only the port.
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime, os, pickle, sys, time
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, root, timeout_s = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], float(sys.argv[4]))
from repro_torch import obs
from repro_torch.launch import mesh as M
from repro_torch.runtime import FaultInjector, VirtualClock
from repro_torch.serve import mesh as serve_mesh
from repro_torch.serve.permanova import PermanovaServer, StudyRequest

# every rank imported before the rendezvous, so a short timeout holds
open(os.path.join(root, f"ready{rank}"), "w").close()
while not all(os.path.exists(os.path.join(root, f"ready{r}"))
              for r in range(world)):
    time.sleep(0.01)
dist.init_process_group("gloo", init_method=f"file://{root}/store",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=timeout_s))
cases = pickle.load(open(os.path.join(root, "cases.pkl"), "rb"))
meshes = {}
for case in cases:       # every mesh before any case: no rendezvous later
    shape = tuple(case["shape"])
    if shape not in meshes:
        meshes[shape] = M.make_mesh(shape, ("data", "model"),
                                    device_type="cpu")


def flat(r):
    d = dict(status=r.status, batched=r.batched, degraded=r.degraded,
             n_perms_done=r.n_perms_done, error=r.error, bucket=r.bucket,
             p_ci=r.p_ci, retries=r.retries, final=r.final is not None,
             history=list(r.report.history) if r.report else [])
    res = r.result
    if res is not None:
        d.update(f_stat=float(res.f_stat), p_value=float(res.p_value),
                 f_perms=res.f_perms.numpy(), n_objects=res.n_objects,
                 n_groups=res.n_groups, s_t=float(res.s_t),
                 s_w=float(res.s_w),
                 terms=[dict(name=t.name, df=t.df, f_stat=float(t.f_stat),
                             p_value=float(t.p_value),
                             f_perms=t.f_perms.numpy())
                        for t in (res.terms or ())])
    return d


def server(case, mesh):
    kw = dict(case["kw"])
    kw["clock"] = VirtualClock()
    inj = case.get("injector")
    if inj is not None:
        f = FaultInjector(seed=inj["seed"])
        if "kill" in inj:
            f.kill_worker_after_blocks(*inj["kill"])
        if "delay" in inj:
            f.delay_block(None, inj["delay"])
        kw["injector"] = f
    table = case.get("draws")
    if table is not None:
        kw["draws"] = lambda req, lo, rows, n_pad: table[
            (req.request_id, lo, rows)]
    return PermanovaServer(device="cpu", mesh=mesh, **kw)


def lead(case, srv):
    reqs = [StudyRequest(**kw) for kw in case["reqs"]]
    if case.get("threads"):
        futs = [srv.submit(r) for r in reqs]    # then one batch of all
        srv.start(threads=2)
        out = [f.result() for f in futs]
        srv.stop()
    elif case.get("split"):                      # two batches
        half = len(reqs) // 2
        out = srv.serve(reqs[:half], batched=True)
        time.sleep(case.get("idle", 0))
        out += srv.serve(reqs[half:], batched=True)
    else:
        out = srv.serve(reqs, batched=True)
    finals = srv.resume_degraded()
    return [flat(r) for r in out], [flat(r) for r in finals]


def fail_once():
    """A follower's next block raises (its first run_block call)."""
    run = serve_mesh.run_block

    def failing(*args, **kw):
        serve_mesh.run_block = run
        raise RuntimeError("injected follower fault")
    serve_mesh.run_block = failing


def fail_staging_once():
    """Rank 0's next batch fails while it stages its operands."""
    enter = serve_mesh.Batch.__enter__

    def failing(self):
        serve_mesh.Batch.__enter__ = enter
        ops = serve_mesh._operands

        def boom(p):
            raise RuntimeError("injected staging fault")
        serve_mesh._operands = boom
        try:
            return enter(self)
        finally:
            serve_mesh._operands = ops
    serve_mesh.Batch.__enter__ = failing


def mesh_stats():
    """This rank's serve.mesh.* counters and serve.mesh.batch spans."""
    out = {k: obs.metrics.value(f"serve.mesh.{k}")
           for k in ("batches", "blocks", "bytes")}
    out["spans"] = sum(e["name"] == "serve.mesh.batch" for e in obs.events())
    return out


obs.enable()
out = {}
for case in cases:
    mesh = meshes[tuple(case["shape"])]
    rec = {}
    obs.metrics.reset()
    obs.clear()
    with server(case, mesh) as srv:
        if srv.is_leader:
            try:
                srv.follow()
            except RuntimeError as e:
                rec["follow_refused"] = str(e)
            if case.get("fail_leader"):
                fail_staging_once()
            rec["mesh"], rec["mesh_finals"] = lead(case, srv)
        else:
            refused = []
            for call in (lambda: srv.submit(None), lambda: srv.serve([]),
                         lambda: srv.process(None), srv.pump,
                         srv.drain_batched, srv.start, srv.resume_degraded):
                try:
                    call()
                except RuntimeError as e:
                    refused.append(str(e))
            rec["refused"] = refused
            if case.get("fail_follower"):
                fail_once()
            try:
                srv.follow()
            except RuntimeError as e:
                rec["follow_error"] = str(e)
    rec["stats"] = mesh_stats()
    if rank == 0:
        rec["twin"], rec["twin_finals"] = lead(case, server(case, None))
    out[case["id"]] = rec
pickle.dump(out, open(os.path.join(root, f"rank{rank}.pkl"), "wb"))
dist.destroy_process_group()
'''


def run_world(root, world: int, cases, timeout_s: float = 1800):
    """Run `cases` on a gloo world of `world` processes (a file store under
    root); each case's record on every rank, {case id: [rank records]}."""
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, logs = [], []
    for r in range(world):
        log = open(root / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world), str(root),
             str(timeout_s)], stdout=log, stderr=subprocess.STDOUT, env=env))
    try:
        rcs = [p.wait(timeout=WORLD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rcs):
        tails = [(root / f"rank{r}.log").read_text()[-3000:]
                 for r in range(world)]
        raise AssertionError(f"world of {world} failed {rcs}:\n"
                             + "\n".join(tails))
    outs = [pickle.load(open(root / f"rank{r}.pkl", "rb"))
            for r in range(world)]
    return {c["id"]: [o[c["id"]] for o in outs] for c in cases}


# ---------------------------------------------------------------------------
# Requests.
# ---------------------------------------------------------------------------

def _study(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    g = rng.integers(0, G, size=n).astype(np.int32)
    g[:G] = np.arange(G)
    return d.astype(np.float32), g


SIZES = (23, 19, 30, 27)      # one bucket: 32


def _requests(kind, count, *, deadline_idx=None):
    out = []
    for s in range(count):
        dm, g = _study(SIZES[s % len(SIZES)], s)
        n = dm.shape[0]
        kw = dict(grouping=g, dm=dm, n_groups=G, n_perms=PERMS, seed=s,
                  request_id=f"{kind}{s}")
        if kind == "strata":
            kw["strata"] = (np.arange(n) % 2).astype(np.int32)
        if kind == "cols":
            kw["covariates"] = np.random.default_rng(40 + s).normal(size=n)
        if s == deadline_idx:
            kw["deadline_s"] = 0.5
        out.append(kw)
    return out


def _ref_draws(kind, reqs):
    """The reference server's masked draws of every block the batch asks
    for ((request id, lo, rows) -> (rows, 32) int32): labels, labels
    within strata, or a dense design's index permutations."""
    table = {}
    n_pad, rows = 32, min(BLOCK, PERMS + 1)
    for kw in reqs:
        g = kw["grouping"]
        n = g.shape[0]
        key = jax.random.key(int(kw["seed"]))
        gp = np.full((n_pad,), G, np.int32)
        gp[:n] = g
        st = np.zeros((n_pad,), np.int32)
        if kw.get("strata") is not None:
            st[:n] = kw["strata"]
        stm = jperm.masked_strata(jnp.asarray(st), jnp.int32(n))
        for lo in range(0, PERMS + 1, BLOCK):
            if kind == "labels":
                d = jperm.masked_permutation_batch_dyn(
                    key, jnp.asarray(gp), jnp.int32(n), jnp.int32(lo), rows)
            elif kind == "strata":
                d = jperm.strata_label_batch_dyn(
                    key, jnp.asarray(gp), stm, jnp.int32(lo), rows)
            else:
                d = jperm.strata_permutation_batch_dyn(
                    key, stm, jnp.int32(lo), rows)
            table[(kw["request_id"], lo, rows)] = np.array(d, np.int32)
    return table


def _case(cid, shape, kind, count, **extra):
    kw = dict(workers=2, block=BLOCK, max_batch=8)
    kw.update(extra.pop("kw", {}))
    return dict(id=cid, shape=shape, kw=kw,
                reqs=extra.pop("reqs", None) or _requests(kind, count),
                **extra)


def _world2_cases():
    draws = {}
    for kind in ("labels", "strata", "cols"):
        reqs = _requests(kind, 3)
        for r in reqs:
            r["request_id"] = "draws-" + r["request_id"]
        draws[kind] = (reqs, _ref_draws(kind, reqs))
    cases = [
        _case("labels", (2, 1), "labels", 3),
        _case("strata", (2, 1), "strata", 2),
        _case("cols", (2, 1), "cols", 3),
        _case("death", (2, 1), "labels", 4, kw=dict(workers=3),
              injector=dict(seed=21, kill=(0, 1))),
        _case("deadline", (2, 1), "labels", 4, kw=dict(workers=3),
              reqs=_requests("labels", 4, deadline_idx=1),
              injector=dict(seed=23, delay=0.2)),
        _case("threads", (2, 1), "labels", 4, threads=True),
        _case("idle", (2, 1), "labels", 4, split=True, idle=IDLE_S),
        _case("follower-fault", (2, 1), "labels", 4, split=True,
              fail_follower=True),
        _case("leader-fault", (2, 1), "labels", 4, split=True,
              fail_leader=True),
    ]
    cases += [_case(f"draws-{kind}", (2, 1), kind, 3, reqs=reqs,
                    draws=table)
              for kind, (reqs, table) in draws.items()]
    return cases


def _world4_cases():
    return [_case("4x1-labels", (4, 1), "labels", 3),
            _case("4x1-cols", (4, 1), "cols", 3),
            _case("2x2-strata", (2, 2), "strata", 3),
            _case("2x2-labels", (2, 2), "labels", 4)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One gloo world of two ranks (a short group timeout) runs every
    world2 case."""
    cases = _world2_cases()
    return cases, run_world(tmp_path_factory.mktemp("serve2"), 2, cases,
                            timeout_s=GROUP_TIMEOUT_S)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = _world4_cases()
    return cases, run_world(tmp_path_factory.mktemp("serve4"), 4, cases)


# ---------------------------------------------------------------------------
# Checks.
# ---------------------------------------------------------------------------

def assert_same(got, want):
    """Two flattened ServeResults, bit for bit."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("status", "degraded", "n_perms_done", "bucket", "p_ci",
                  "error", "batched", "final"):
            assert a[k] == b[k], (k, a[k], b[k])
        if "f_perms" not in b:
            continue
        for k in ("f_stat", "p_value", "s_t", "s_w", "n_objects"):
            assert a[k] == b[k], (k, a[k], b[k])
        np.testing.assert_array_equal(a["f_perms"], b["f_perms"])
        assert len(a["terms"]) == len(b["terms"])
        for t, u in zip(a["terms"], b["terms"]):
            assert (t["name"], t["f_stat"], t["p_value"]) == \
                (u["name"], u["f_stat"], u["p_value"])
            np.testing.assert_array_equal(t["f_perms"], u["f_perms"])


def _slots(s_count, data_ways, d):
    """The studies of 'data' index d, as engine.api.put_study_sharded
    splits a wrap-padded study axis (computed here on its own)."""
    total = -(-s_count // data_ways) * data_ways
    per = total // data_ways
    return [i % s_count for i in range(d * per, (d + 1) * per)]


def _operand_bytes(kw):
    """The bytes one study's operands take in the 32 bucket."""
    n_pad = 32
    if kw.get("covariates") is not None:
        k = 1 + 1 + (G - 1)      # intercept, the covariate, the grouping
        return 4 * (n_pad * n_pad + n_pad * k + n_pad)
    out = 4 * (n_pad * n_pad + n_pad + G)
    return out + (4 * n_pad if kw.get("strata") is not None else 0)


def expected_bytes(case, rank):
    """Exactly the operands of `rank`'s block's studies, each once; plus
    the explicit draws of its studies when the case feeds them."""
    data_ways, model_ways = case["shape"]
    reqs = case["reqs"]
    if case.get("split"):          # two batches
        halves = [reqs[:len(reqs) // 2], reqs[len(reqs) // 2:]]
    else:
        halves = [reqs]
    total = 0
    for batch in halves:
        for s in dict.fromkeys(_slots(len(batch), data_ways,
                                      rank // model_ways)):
            total += _operand_bytes(batch[s])
            if case.get("draws") is not None:
                n_blocks = -(-(PERMS + 1) // BLOCK)
                total += n_blocks * 4 * min(BLOCK, PERMS + 1) * 32
    return total


def check_bytes(case, per_rank):
    """Each follower received exactly its block's operands, rank 0 sent
    their sum, and every rank counted the same batches (a span each) and
    block commands."""
    lead = per_rank[0]
    world = len(per_rank)
    assert lead["stats"]["bytes"] == sum(expected_bytes(case, r)
                                         for r in range(1, world))
    for rank in range(1, world):
        stats = per_rank[rank]["stats"]
        assert stats["bytes"] == expected_bytes(case, rank), rank
        assert stats["blocks"] == lead["stats"]["blocks"] > 0
        assert stats["batches"] == lead["stats"]["batches"] \
            == stats["spans"] == lead["stats"]["spans"] > 0


def check_case(case, per_rank):
    lead = per_rank[0]
    assert_same(lead["mesh"], lead["twin"])
    assert_same(lead["mesh_finals"], lead["twin_finals"])
    for r in lead["mesh"]:
        assert r["status"] in ("ok", "degraded"), r["error"]
        assert r["batched"]
    for rec in per_rank[1:]:
        assert "follow_error" not in rec, rec["follow_error"]
    check_bytes(case, per_rank)


WORLD2 = [c["id"] for c in _world2_cases()]
WORLD4 = [c["id"] for c in _world4_cases()]


@pytest.mark.parametrize("cid", [c for c in WORLD2
                                 if not c.startswith(("draws", "follower",
                                                      "leader"))])
def test_two_ranks_equal_the_unsharded_server(world2, cid):
    cases, out = world2
    check_case(next(c for c in cases if c["id"] == cid), out[cid])


@pytest.mark.parametrize("cid", WORLD4)
def test_four_ranks_equal_the_unsharded_server(world4, cid):
    cases, out = world4
    check_case(next(c for c in cases if c["id"] == cid), out[cid])


def test_a_worker_death_and_a_deadline_under_the_mesh(world2):
    """The chaos cases really faulted: a worker died (its blocks were
    re-dispatched), and one member degraded, then resumed unsharded to
    the exact result."""
    _, out = world2
    death = out["death"][0]["mesh"]
    assert any(any("kill worker=0" in h for h in r["history"])
               for r in death)
    deadline = out["deadline"][0]
    assert [r["status"] for r in deadline["mesh"]] == \
        ["ok", "degraded", "ok", "ok"]
    assert 0 < deadline["mesh"][1]["n_perms_done"] < PERMS
    (exact,) = deadline["mesh_finals"]
    assert exact["status"] == "ok" and exact["n_perms_done"] == PERMS


def test_a_failing_follower_fails_its_batch_only(world2):
    """A block raised on rank 1 in the first of two batches: rank 0's
    members of that batch come out failed with the follower's message
    (after the status gather that every rank joined), the second batch
    equals the server without a mesh bit for bit, and the follower's
    follow() raises at stop, naming the block."""
    cases, out = world2
    case = next(c for c in cases if c["id"] == "follower-fault")
    lead, fol = out["follower-fault"]
    first, second = lead["mesh"][:2], lead["mesh"][2:]
    for r in first:
        assert r["status"] == "failed"
        assert "follower rank(s) [1] failed block 0" in r["error"]
        assert "injected follower fault" in r["error"]
    assert_same(second, lead["twin"][2:])
    assert [r["status"] for r in lead["twin"]] == ["ok"] * 4
    assert "follower rank 1 failed block 0" in fol["follow_error"]
    assert "injected follower fault" in fol["follow_error"]
    assert lead["stats"]["blocks"] == fol["stats"]["blocks"] \
        == 1 + -(-(PERMS + 1) // BLOCK)
    check_bytes(case, out["follower-fault"])


def test_a_batch_rank_0_cannot_stage_reaches_no_follower(world2):
    """Rank 0 failed to stage the first batch's operands: that batch's
    members come out failed, no follower ever saw it (it would wait in
    a recv past the group's timeout), and the second batch equals the
    server without a mesh bit for bit."""
    cases, out = world2
    case = next(c for c in cases if c["id"] == "leader-fault")
    lead, fol = out["leader-fault"]
    for r in lead["mesh"][:2]:
        assert r["status"] == "failed"
        assert "injected staging fault" in r["error"]
    assert_same(lead["mesh"][2:], lead["twin"][2:])
    assert "follow_error" not in fol
    blocks = -(-(PERMS + 1) // BLOCK)
    for rec in (lead, fol):
        assert rec["stats"]["batches"] == rec["stats"]["spans"] == 1
        assert rec["stats"]["blocks"] == blocks
    # the second batch's rank-1 block: its second study
    assert fol["stats"]["bytes"] == lead["stats"]["bytes"] \
        == _operand_bytes(case["reqs"][3])


def _null_allowance(res):
    """PERF.md §2's f32 allowance on each null F (per term for a
    design)."""
    if not res["terms"] or len(res["terms"]) == 1:
        c = (res["n_objects"] - res["n_groups"]) / (res["n_groups"] - 1)
        return {None: NULL_RTOL * (np.abs(res["f_perms"]) + c)}
    k = sum(t["df"] for t in res["terms"]) + 1
    dof = res["n_objects"] - k
    e = NULL_RTOL / 2 * res["s_t"]
    return {t["name"]: 2.0 * e * (k * np.abs(t["f_perms"]) + dof)
            / res["s_w"] for t in res["terms"]}


@pytest.mark.parametrize("kind", ["labels", "strata", "cols"])
def test_explicit_draws_match_the_reference_server(world2, kind):
    """draws= under the mesh, fed the reference's masked draws: the
    no-mesh port server's bits, and the reference server's F at rtol
    1e-4 and p equal (each null F within the f32 allowance)."""
    cases, out = world2
    cid = f"draws-{kind}"
    case = next(c for c in cases if c["id"] == cid)
    check_case(case, out[cid])
    ref = jserve.PermanovaServer(workers=2, block=BLOCK).serve(
        [jserve.StudyRequest(**kw) for kw in case["reqs"]], batched=True)
    for got, want in zip(out[cid][0]["mesh"], ref):
        assert got["status"] == want.status == "ok"
        assert got["bucket"] == want.bucket
        allow = _null_allowance(got)
        pairs = ([(got, want.result)] if None in allow else
                 list(zip(got["terms"], want.result.terms)))
        for t, u in pairs:
            name = t.get("name") if None not in allow else None
            np.testing.assert_allclose(t["f_stat"], float(u.f_stat),
                                       rtol=RTOL)
            assert np.float32(t["p_value"]) == np.float32(float(u.p_value))
            d_null = np.abs(t["f_perms"].astype(np.float64)
                            - np.asarray(u.f_perms, np.float64))
            assert bool((d_null <= allow[name]).all()), name


def test_followers_outlive_an_idle_gap_and_stop(world2):
    """The idle case slept IDLE_S seconds between its two batches, past
    the world's GROUP_TIMEOUT_S: the follower polled the store, waited
    in no collective, served the second batch and returned on stop()
    (every case's follow() returned, or the world would have timed
    out)."""
    assert IDLE_S > GROUP_TIMEOUT_S
    _, out = world2
    idle = out["idle"]
    assert idle[0]["stats"]["batches"] == idle[1]["stats"]["batches"] == 2
    assert [r["status"] for r in idle[0]["mesh"]] == ["ok"] * 4


def test_a_followers_admission_calls_raise(world2, world4):
    for _, out in (world2, world4):
        for cid, per_rank in out.items():
            assert "follower" in per_rank[0]["follow_refused"]
            for rec in per_rank[1:]:
                assert len(rec["refused"]) == 7, cid
                assert all("rank 0" in m for m in rec["refused"])


def test_a_one_rank_mesh_serves_unsharded(tmp_path):
    """A mesh whose 'data' axis is 1 (a world of one) serves as the
    server without a mesh, bit for bit, and follow() is refused."""
    from repro_torch.launch import mesh as pmesh
    reqs = _requests("labels", 3)
    with pmesh.world_of_one("cpu", tmp_path):
        mesh = pmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
        obs.metrics.reset()
        with obs.session(), PermanovaServer(device="cpu", mesh=mesh,
                                            workers=2, block=BLOCK) as srv:
            got = srv.serve([StudyRequest(**kw) for kw in reqs],
                            batched=True)
            with pytest.raises(RuntimeError, match="follower"):
                srv.follow()
            assert obs.metrics.value("serve.batches") == 1
            assert not any(k.startswith("serve.mesh.") for k in
                           obs.metrics.snapshot()["counters"])
        with pytest.raises(ValueError, match="device type"):
            PermanovaServer(device="cuda", mesh=mesh)
    want = PermanovaServer(device="cpu", workers=2, block=BLOCK).serve(
        [StudyRequest(**kw) for kw in reqs], batched=True)
    for a, b in zip(got, want):
        assert a.status == b.status == "ok" and a.batched
        assert torch.equal(a.result.f_perms, b.result.f_perms)
        assert float(a.result.p_value) == float(b.result.p_value)
    assert not torch.distributed.is_initialized()
