"""Serving launcher: the always-on PERMANOVA service on the port.

Twin of `repro/launch/serve.py permanova` (the `lm` subcommand belongs to
the LM scaffold, not ported here):

  # chaos smoke: a synthetic stream of studies, replayed coalesced by
  # shape bucket (bit-identical to serial, then a warm replay that builds
  # and loads no kernel library and misses no bucket) and with a worker
  # killed mid-request (bit-identical to the failure-free run)
  PYTHONPATH=src python -m repro_torch.launch.serve permanova \
      --studies 6 --workers 3 --batch 4 --inject-death \
      --trace serve_trace.json

Runs on the card (`--device cuda`, the default) and fails without one;
`--device cpu` runs the plain PyTorch forms on the host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs import cudahooks


def _pa_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--studies", type=int, default=6,
                    help="number of synthetic studies to admit")
    ap.add_argument("--n-min", type=int, default=18)
    ap.add_argument("--n-max", type=int, default=40)
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--n-perms", type=int, default=199)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--queue-limit", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-death", action="store_true",
                    help="replay the stream with a worker killed mid-"
                         "request and assert bit-identical results")
    ap.add_argument("--batch", type=int, default=0,
                    help="replay the stream with same-bucket requests "
                         "coalesced into batched dispatches of up to this "
                         "many studies; asserts bit-identity against the "
                         "serial run, then a warm replay with no kernel "
                         "build or load and no bucket miss")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the serve session")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; fails without a card) or cpu")


def _synth_stream(args: argparse.Namespace) -> list:
    from repro_torch.core.distance import distance_matrix
    from repro_torch.serve.permanova import StudyRequest

    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.studies):
        n = int(rng.integers(args.n_min, args.n_max + 1))
        x = rng.normal(size=(n, 5)).astype(np.float32)
        g = rng.integers(0, args.groups, size=n).astype(np.int32)
        dm = distance_matrix(torch.from_numpy(x), "euclidean").numpy()
        reqs.append(StudyRequest(grouping=g, dm=dm, n_perms=args.n_perms,
                                 seed=i, request_id=f"study{i}"))
    return reqs


def _server(args: argparse.Namespace, **kw):
    from repro_torch.serve.permanova import PermanovaServer
    return PermanovaServer(workers=args.workers, block=args.block,
                           queue_limit=args.queue_limit, device=args.device,
                           **kw)


def _assert_same(clean, other, what: str) -> None:
    for c, o in zip(clean, other):
        assert o.ok, f"{o.request_id} failed {what}: {o.error}"
        assert torch.equal(c.result.f_stat, o.result.f_stat), \
            f"{c.request_id}: F diverged {what}"
        assert torch.equal(c.result.p_value, o.result.p_value), \
            f"{c.request_id}: p diverged {what}"
        assert torch.equal(c.result.f_perms, o.result.f_perms), \
            f"{c.request_id}: permutation set diverged {what}"


def cmd_permanova(args: argparse.Namespace) -> int:
    from repro_torch.runtime.faultinject import FaultInjector
    from repro_torch.serve.permanova import serve_stats_from_events

    reqs = _synth_stream(args)
    with obs.session(args.trace):
        clean = _server(args).serve(reqs)
        stats = serve_stats_from_events(obs.events())
    bad = [r for r in clean if not r.ok]
    for r in clean:
        if r.ok:
            print(f"[serve.pa] {r.request_id}: status={r.status} "
                  f"F={float(r.result.f_stat):.5f} "
                  f"p={float(r.result.p_value):.4f} "
                  f"bucket={r.bucket} wall={r.wall_s:.2f}s")
    print(f"[serve.pa] requests={stats['requests']} "
          f"rps={stats['requests_per_s']:.2f} "
          f"p50={stats['p50_s'] * 1e3:.1f}ms "
          f"p99={stats['p99_s'] * 1e3:.1f}ms on {args.device}")
    if bad:
        print(f"[serve.pa] FAILED requests: "
              f"{[(r.request_id, r.error) for r in bad]}")
        return 1
    if args.trace:
        print(f"[serve.pa] trace written to {args.trace}")

    if args.batch:
        # batched smoke: the same stream coalesced by shape bucket; each
        # study runs on its serial step's launches, so the batched
        # dispatch is bit-identical to serial serving, and a second warm
        # replay of the same server builds and loads no kernel library
        # and misses no bucket (the reference counts zero retraces)
        with obs.session():
            srv = _server(args, max_batch=args.batch)
            batched = srv.serve(reqs, batched=True, max_batch=args.batch)
            _assert_same(clean, batched, "under batching")
            keys = (cudahooks.BUILDS, cudahooks.LOADS, "serve.bucket_misses")
            before = {k: obs.metrics.value(k, 0.0) for k in keys}
            warm = srv.serve(reqs, batched=True, max_batch=args.batch)
            after = {k: obs.metrics.value(k, 0.0) for k in keys}
            _assert_same(clean, warm, "on the warm batched replay")
            grew = {k: after[k] - before[k] for k in keys
                    if after[k] != before[k]}
            assert not grew, f"warm batched replay: {grew}"
            n_b = obs.metrics.value("serve.batches", 0.0)
            n_br = obs.metrics.value("serve.batched_requests", 0.0)
        print(f"[serve.pa] batched: max_batch={args.batch} "
              f"batches={n_b:.0f} batched_requests={n_br:.0f} -> "
              "bit-identical to serial; the warm replay built 0 and "
              "loaded 0 kernel libraries and missed 0 buckets")

    if args.inject_death:
        # chaos smoke: kill worker 0 two blocks into the stream; the
        # idempotent-block contract (draws keyed by global index) must
        # reconverge to bit-identical statistics
        inj = FaultInjector(seed=args.seed)
        inj.kill_worker_after_blocks(0, 2)
        faulty = _server(args, injector=inj).serve(reqs)
        _assert_same(clean, faulty, "under worker death")
        print(f"[serve.pa] chaos: worker death injected -> "
              f"{len(faulty)} requests bit-identical to the clean run "
              f"(F, p, permutation sets)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _pa_args(sub.add_parser(
        "permanova", help="always-on PERMANOVA service smoke"))
    args = ap.parse_args(argv)
    return cmd_permanova(args)


if __name__ == "__main__":
    raise SystemExit(main())
