"""A coalesced batch on rank 0, and serving on a mesh: the other ranks
follow.

The reference's server is one controller process that only `device_put`s
a coalesced batch's study axis over the mesh's 'data' axis. The port is
SPMD on torch.distributed: every rank constructs the same
`PermanovaServer(mesh=...)`. Rank 0 admits, prepares, batches, checkpoints
and answers; every other rank runs `PermanovaServer.follow()`, which
executes rank 0's commands until rank 0's `stop()` releases it.

Every coalesced batch is one `Batch`: rank 0's block of the study axis
moves to its device study by study, and `compute(lo, hi)` runs it through
scheduler.sw_block_many / sw_cols_block_many, the launches the serial
path makes for each study. Without followers (no mesh, or a 'data' axis
of 1) rank 0's block is every study. On a mesh with followers the study
axis is wrap-padded over 'data' and split into blocks as
`engine.api.put_study_sharded` splits it:

  begin  the batch's metadata (mode, impl, block, seeds, n_valid,
         n_totals, operand shapes); then rank 0 sends each follower the
         operands of its block's studies (`dist.send`, in rank order, in
         pieces of `PIECE_BYTES`; a padded slot replays its source study,
         which travels once).
  block  one per `compute(lo, hi)` of rank 0's elastic executor, in its
         order (re-dispatches, speculative copies and retries included);
         with explicit draws rank 0 then sends each follower its studies'
         rows. Every rank runs its block, and two all-gathers (the rows, a
         status) bring every rank's rows to rank 0, which takes them in
         'data' order and cuts the padded slots: the batch equals the
         unsharded one bit for bit.
  end    the followers free the batch's operands.
  stop   follow() returns.

Commands travel through the process group's store, which the followers
poll: between commands a follower waits in no collective, so an idle
server outlives the group's timeout. What can fail on rank 0 (host
operands, its own block's device copies, the NCCL staging buffer, the
explicit draws) is done before the command that needs it is published,
so a follower is never left waiting for a piece that does not come.
Every collective of a command is issued by every rank once it has read
the command, and a failure on any rank rides in the status gather, so
rank 0 raises only after the gather completes: no rank is left inside a
half-issued collective. Under gloo a card's tensors travel through host
copies; under NCCL rank 0 stages each piece in one card buffer.

Telemetry (obs, on every rank): counters serve.mesh.batches,
serve.mesh.blocks and serve.mesh.bytes (operand and draw bytes sent by
rank 0, received by a follower) and a serve.mesh.batch span from begin
to end. The request-level serve.* counters and spans stay on rank 0.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d as _c10d

from repro_torch import obs as _obs
from repro_torch.core import distributed as _distrib
from repro_torch.engine import registry, scheduler
from repro_torch.engine.api import put_study_sharded

PREFIX = "permanova-serve"
PIECE_BYTES = 256 * 2 ** 20     # a send's largest piece
POLL_S = (0.0005, 0.05)         # a follower's first and longest poll sleep


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name.split(".")[-1])


class Channel:
    """Rank 0's commands to the followers, as JSON values under keys
    `cmd/<seq>` of the default group's store (a prefix of its own for
    each server: every rank counts the mesh servers it builds, and SPMD
    ranks build them in the same order)."""

    def __init__(self):
        store = _c10d._get_default_store()
        gen = store.add(f"{PREFIX}/servers/rank{dist.get_rank()}", 1)
        self.store = dist.PrefixStore(f"{PREFIX}/{gen}/", store)
        self.seq = 0          # the next command
        self._kept = 0        # rank 0: the first key not yet deleted

    def publish(self, cmd: dict) -> None:
        self.store.set(f"cmd/{self.seq}", json.dumps(cmd))
        self.seq += 1

    def next(self) -> dict:
        """The next command; polls the store (no collective) until it
        comes."""
        key = f"cmd/{self.seq}"
        sleep = POLL_S[0]
        while not self.store.check([key]):
            time.sleep(sleep)
            sleep = min(sleep * 1.5, POLL_S[1])
        self.seq += 1
        return json.loads(self.store.get(key))

    def retire(self) -> None:
        """Delete the commands every follower has read: called by rank 0
        after a collective that every rank joined."""
        for s in range(self._kept, self.seq):
            self.store.delete_key(f"cmd/{s}")
        self._kept = self.seq

    def note_error(self, rank: int, msg: str) -> None:
        self.store.set(f"err/{rank}", msg)

    def error_of(self, rank: int) -> str:
        key = f"err/{rank}"
        return (self.store.get(key).decode() if self.store.check([key])
                else "no message")


def _transport(dev: torch.device) -> torch.device:
    """Where tensors travel: the card under NCCL, the host under gloo."""
    return dev if dist.get_backend() == "nccl" else torch.device("cpu")


def _send(t: torch.Tensor, dst: int, stage: Optional[torch.Tensor]) -> int:
    """Send contiguous host tensor `t` to rank `dst` in pieces, through
    the card buffer `stage` (NCCL) or straight from the host (gloo); its
    byte count."""
    flat = t.view(-1)
    size = flat.element_size()
    step = PIECE_BYTES // size
    for i in range(0, flat.numel(), step):
        piece = flat[i:i + step]
        if stage is not None:
            piece = stage[: piece.numel() * size].view(piece.dtype).copy_(
                piece)
        dist.send(piece, dst)
    return flat.numel() * size


def _recv(shape, dtype: torch.dtype, dev: torch.device):
    """Receive one tensor sent by `_send` from rank 0 onto `dev`. If the
    device copy fails, the pieces are still received (the protocol goes
    on) and the error is returned: (tensor or None, bytes, error)."""
    via = _transport(dev)
    numel = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    err = None
    try:
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.view(-1)
    except RuntimeError as e:          # e.g. the card's memory is full
        out, flat, err = None, None, f"{type(e).__name__}: {e}"
    step = PIECE_BYTES // size
    for i in range(0, numel, step):
        n = min(step, numel - i)
        if flat is not None and via == dev:
            dist.recv(flat[i:i + n], src=0)
            continue
        buf = torch.empty((n,), dtype=dtype, device=via)
        dist.recv(buf, src=0)
        if flat is not None:
            flat[i:i + n].copy_(buf)
    return out, numel * size, err


def unique(studies) -> list:
    return list(dict.fromkeys(studies))


def run_block(ops: Dict[int, dict], studies: List[int], meta: dict,
              lo: int, fn, draws: Optional[dict]) -> torch.Tensor:
    """This rank's rows of one block: (len(studies), block) s_W, or
    (len(studies), block, K) for a dense design, each study on the
    launches the serial path makes for it."""
    blk = int(meta["block"])
    seeds = [int(meta["seeds"][s]) for s in studies]
    n_valid = [int(meta["n_valid"][s]) for s in studies]
    n_totals = [int(meta["n_totals"][s]) for s in studies]
    per = [ops[s] for s in studies]
    slot_draws = (None if draws is None
                  else [draws.get(s) for s in studies])
    if "basis" in per[0]:
        return scheduler.sw_cols_block_many(
            [o["mat2"] for o in per], [o["basis"] for o in per],
            [o["strata"] for o in per], n_valid, seeds, lo, fn=fn,
            block=blk, n_totals=n_totals, index_perms=slot_draws)
    strata = ([o["strata"] for o in per] if "strata" in per[0] else None)
    return scheduler.sw_block_many(
        [o["mat2"] for o in per], [o["grouping"] for o in per], n_valid,
        [o["inv_gs"] for o in per], seeds, lo, fn=fn, block=blk,
        strata=strata, n_totals=n_totals, perms=slot_draws)


def rows_shape(meta: dict, n_studies: int) -> tuple:
    """The shape of a rank's rows for one block."""
    k = [shape for name, shape, _ in meta["specs"] if name == "basis"]
    return (n_studies, int(meta["block"])) + ((int(k[0][1]),) if k else ())


def gather(rows: torch.Tensor, failed: bool, lay) -> tuple:
    """Every rank's rows and status, in rank order."""
    status = torch.tensor([int(failed)], dtype=torch.int32,
                          device=rows.device)
    return (_distrib.all_gather(rows, lay),
            [int(s) for s in _distrib.all_gather(status, lay)])


def _operands(p) -> list:
    """(name, contiguous host tensor) of a prepared request's batch
    operands, in the order they travel."""
    if p.basis is not None:
        out = [("mat2", torch.from_numpy(p.mat2)), ("basis", p.basis),
               ("strata", p.strata)]
    else:
        out = [("mat2", torch.from_numpy(p.mat2)),
               ("grouping", torch.from_numpy(p.grouping)),
               ("inv_gs", torch.from_numpy(p.inv_gs))]
        if p.strata is not None:
            out.append(("strata", torch.from_numpy(p.strata)))
    return [(name, t.contiguous()) for name, t in out]


class Batch:
    """Rank 0's side of one coalesced batch, as a context manager:
    `compute(lo, hi)` is the elastic executor's block function. With a
    `channel` (a mesh whose 'data' axis is over 1) entering begins the
    batch on every follower and leaving ends it; without one, rank 0 runs
    every study. `draws`: the server's explicit-draws seam, or None."""

    def __init__(self, preps, impl: str, tuning: dict, fn, block: int,
                 device: torch.device, *, mesh=None, channel=None,
                 draws=None):
        self.preps, self.fn, self.dev = preps, fn, device
        self.channel, self.draws = channel, draws
        s_count = len(preps)
        specs = [[name, list(t.shape), str(t.dtype)]
                 for name, t in _operands(preps[0])]
        self.meta = dict(
            op="begin", impl=impl, tuning=dict(tuning), block=int(block),
            n_studies=s_count, specs=specs,
            seeds=[int(p.req.seed) for p in preps],
            n_valid=[int(p.n) for p in preps],
            n_totals=[int(p.n_total) for p in preps])
        if channel is None:
            self.lay = None
            self.blocks = [list(range(s_count))]
        else:
            self.lay = _distrib.layout(mesh)
            self.blocks = [put_study_sharded(mesh, s_count, rank=r).studies
                           for r in range(self.lay.world)]
        self.ops: Dict[int, dict] = {}
        self.stage = None
        self._span = _obs.core.NOOP_SPAN

    def __enter__(self) -> "Batch":
        host = {s: _operands(self.preps[s])
                for b in self.blocks for s in unique(b)}
        self.ops = {s: {name: t.to(self.dev) for name, t in host[s]}
                    for s in unique(self.blocks[0])}
        if self.channel is None:
            return self
        if _transport(self.dev) != torch.device("cpu"):
            self.stage = torch.empty((PIECE_BYTES,), dtype=torch.uint8,
                                     device=self.dev)
        self._span = _obs.span("serve.mesh.batch",
                               {"studies": len(self.preps)})
        self._span.__enter__()
        self.channel.publish(self.meta)
        _obs.metrics.inc("serve.mesh.batches")
        try:
            for r in range(1, self.lay.world):
                for s in unique(self.blocks[r]):
                    for _, t in host[s]:
                        _obs.metrics.inc("serve.mesh.bytes",
                                         _send(t, r, self.stage))
        except BaseException:      # the transport itself failed
            self.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc) -> bool:
        self.ops, self.stage = {}, None
        if self.channel is not None:
            self.channel.publish(dict(op="end"))
            self._span.__exit__(*exc)
        return False

    def _draws_of(self, lo: int) -> Optional[dict]:
        """Block lo's explicit draws of each study that computes rows in
        it, on the host, or None (each study draws from its seed)."""
        if self.draws is None:
            return None
        out = {}
        for s, p in enumerate(self.preps):
            rows = scheduler._study_rows(self.meta["block"], lo,
                                         self.meta["n_totals"], s)
            if rows:
                out[s] = torch.from_numpy(np.array(
                    self.draws(p.req, lo, rows, p.n_pad), np.int32))
        return out

    def _run_own(self, lo: int, draws: Optional[dict]) -> torch.Tensor:
        if draws is not None:
            draws = {s: d.to(self.dev) for s, d in draws.items()
                     if s in self.ops}
        return run_block(self.ops, self.blocks[0], self.meta, lo, self.fn,
                         draws)

    def compute(self, lo: int, hi: int) -> np.ndarray:
        draws = self._draws_of(lo)       # a raising draw issues nothing
        if self.channel is None:
            return self._columns(self._run_own(lo, draws), hi - lo)
        ch, lay = self.channel, self.lay
        ch.publish(dict(op="block", lo=int(lo), draws=draws is not None))
        _obs.metrics.inc("serve.mesh.blocks")
        if draws is not None:
            for r in range(1, lay.world):
                for s in unique(self.blocks[r]):
                    if s in draws:
                        _obs.metrics.inc("serve.mesh.bytes",
                                         _send(draws[s], r, self.stage))
        err = None
        try:
            rows = self._run_own(lo, draws)
        except Exception as e:    # joined the gather first, raised below
            err = f"{type(e).__name__}: {e}"
            rows = torch.zeros(rows_shape(self.meta, len(self.blocks[0])),
                               dtype=torch.float32, device=self.dev)
        parts, status = gather(rows, err is not None, lay)
        ch.retire()
        if err is not None:
            raise RuntimeError(f"rank 0 failed block {lo}: {err}")
        bad = [r for r, s in enumerate(status) if s]
        if bad:
            raise RuntimeError(
                f"follower rank(s) {bad} failed block {lo}: "
                + "; ".join(ch.error_of(r) for r in bad))
        full = torch.cat([parts[lay.first_rank(data=d)]
                          for d in range(lay.data_ways)])
        return self._columns(full[: len(self.preps)], hi - lo)

    @staticmethod
    def _columns(rows: torch.Tensor, n: int) -> np.ndarray:
        """(S, block[, K]) rows as the batch's (n, S[, K]) block."""
        out = rows.cpu().numpy()
        out = out.transpose(1, 0, 2) if out.ndim == 3 else out.T
        return out[:n]


def follow(channel: Channel, mesh, device: torch.device) -> None:
    """A follower rank's loop (PermanovaServer.follow): run rank 0's
    commands until its stop; raises RuntimeError at stop when a block
    failed on this rank."""
    lay = _distrib.layout(mesh)
    meta, ops, studies, fn = None, {}, [], None
    batch_err = first_err = None
    span = _obs.core.NOOP_SPAN
    while True:
        cmd = channel.next()
        op = cmd["op"]
        if op == "begin":
            meta, ops, batch_err = cmd, {}, None
            span = _obs.span("serve.mesh.batch",
                             {"studies": int(meta["n_studies"])})
            span.__enter__()
            _obs.metrics.inc("serve.mesh.batches")
            studies = put_study_sharded(mesh, meta["n_studies"]).studies
            for s in unique(studies):
                ops[s] = {}
                for name, shape, dtype in meta["specs"]:
                    t, nbytes, err = _recv(shape, _dtype(dtype), device)
                    ops[s][name] = t
                    _obs.metrics.inc("serve.mesh.bytes", nbytes)
                    batch_err = batch_err or err
            cols = any(name == "basis" for name, _, _ in meta["specs"])
            try:
                fn = registry.bound_sw(meta["impl"], cols=cols,
                                       **meta["tuning"])
            except (KeyError, ValueError) as e:
                batch_err = batch_err or f"{type(e).__name__}: {e}"
        elif op == "block":
            _obs.metrics.inc("serve.mesh.blocks")
            lo = int(cmd["lo"])
            draws = None
            if cmd["draws"]:
                draws = {}
                for s in unique(studies):
                    rows = scheduler._study_rows(meta["block"], lo,
                                                 meta["n_totals"], s)
                    if rows:
                        n_pad = int(meta["specs"][0][1][0])
                        t, nbytes, err = _recv((rows, n_pad), torch.int32,
                                               device)
                        draws[s] = t
                        _obs.metrics.inc("serve.mesh.bytes", nbytes)
                        batch_err = batch_err or err
            err = batch_err
            rows_t = None
            if err is None:
                try:
                    rows_t = run_block(ops, studies, meta, lo, fn, draws)
                except Exception as e:   # reported through the gather
                    err = f"{type(e).__name__}: {e}"
            if rows_t is None:
                rows_t = torch.zeros(rows_shape(meta, len(studies)),
                                     dtype=torch.float32, device=device)
            if err is not None:
                channel.note_error(lay.rank, err)
                first_err = first_err or f"block {lo}: {err}"
            gather(rows_t, err is not None, lay)
        elif op == "end":
            meta, ops, studies, fn = None, {}, [], None
            span.__exit__(None, None, None)
            span = _obs.core.NOOP_SPAN
        elif op == "stop":
            if first_err is not None:
                raise RuntimeError(f"follower rank {lay.rank} failed "
                                   f"{first_err}")
            return
        else:
            raise RuntimeError(f"unknown serving command {op!r}")
