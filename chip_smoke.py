#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`src/repro_torch`) on one H100.

    python3 chip_smoke.py

Phases, each timed:

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the kernels from `csrc/` with nvcc.
2. Every permanova_sw kernel against its plain PyTorch version on the card
   at (n, P, G) = (57, 1, 3), (130, 5, 2), (2047, 37, 8), (400, 3, 300)
   (the matmul kernel's 256-column slices) and (100, 7, 1): f32 at
   rtol=1e-4, atol=1e-5, the brute and permblock kernels within 1e-6
   relative, brute also at n and P on both sides of its 64-row bands,
   64-column tiles and 128-permutation blocks (BRUTE_EDGE_SHAPES), and
   permblock (the paper's Algorithm 2: each staged tile for every
   permutation) at n and P on both sides of its bands, its 16-tile strips
   (n = 1,023 / 1,024 / 1,025, 2,047 / 2,048 / 2,049) and its
   128-permutation passes (P = 127 / 128 / 129 / 257), there also within
   1e-6 of the plain version in float64 (PERMBLOCK_EDGE_SHAPES); the
   matmul kernel on bf16
   mat2 against the plain version on the same bf16-rounded operands at
   rtol=1e-4, and against a float64 reference on the f32 operands at 5e-3
   relative (the reference package's own bar for bf16).
3. The main path at the paper's EMP shape: synthetic_study(25145, 128, 8,
   effect 1.0) -> Bray-Curtis D -> engine.run(impl="auto", 3,999 perms),
   which the planner sends to the brute kernel in 2 streamed label
   chunks; then impl brute, tiled and matmul on the same explicit labels
   at 999 permutations, which must agree on F (rtol=1e-4) and exactly on
   p, and on the whole null distribution within what f32 s_W allows (see
   SW_MAIN_RTOL). The kernels' launch counts are set to 0 just before each
   of these four runs and read just after it: the auto run must launch
   the brute kernel once per chunk and nothing else (no chunk may take a
   CPU path), each pinned run its own kernel once per chunk of the card's
   plan for that impl (tiled's charges the permblock kernel's partials)
   and nothing else.
4. The label draws of a dense / stream bridge chunk (2,668 permutations,
   free and within 4 strata): drawn in the label budget's sub-blocks they
   equal the whole chunk drawn at once bit for bit, and their device
   memory above the start, less the labels, stays within the 256 MiB
   label budget; both ways timed, and the design path's index draw; each
   kind of draw (free labels, labels within strata, index permutations)
   as one sub-block of 1 to 107 rows, its transients under
   core.permutations' model for that kind, and timed. Then
   each kernel timed at the shape the main path gives it, beside its
   plain version, one PyTorch library call where one computes the same
   function, and its bound on this card; at that shape each kernel's s_W
   must also match the plain version's within SW_MAIN_RTOL, the matmul
   kernel's on bf16 mat2 too (against the plain one-hot form on the same
   bf16 operands), with its f32 and bf16 times beside the library call,
   its one-hot TFLOP/s and its one-hot form's own floors (two TF32 or one
   bf16 tensor-core product at the dense peak, and the bytes of its mat2
   passes); the brute kernel beside its own floor (one INT32 compare per
   (pair, permutation) at the INT32 pipe's rate; a time under a floor
   fails the run). The permblock kernel is also timed in turns with brute
   on the same labels at P = 1,000 and at brute's chunk (2,668), each
   beside its bound and the same INT32 floor, within 1e-6 of the plain
   version at both; and a tiled chunk of the card's plan (2 chunks for
   4,000 slots) must keep its labels plus the (blocks, chunk) partials a
   launch allocates within the 256 MiB label budget. Then engine.run on the card against engine.run on the CPU at
   n=300 (same seed, so the same labels).
5. Every pairwise-distance kernel (braycurtis, euclidean, jaccard,
   jaccard_packed) against its plain PyTorch version on the card at
   (nr, nc, d) = (57, 57, 3), (130, 130, 37), (2047, 2047, 128) and
   (256, 25145, 128), the stream bridge's slab at the EMP shape: f32 at
   rtol=1e-4, atol=1e-5 (the reference's own bar), and jaccard_packed
   equal to the jaccard kernel bit for bit on the same presence data.
   Then each kernel's whole-table call (one table as both operands: the
   symmetric visit of the 128 x 128 tiles j >= i, each mirrored) against
   the rectangular call on a clone of the table, bit for bit off the
   diagonal, and against its plain version at the same bar, at (n, d) =
   (57, 3), (130, 37), (2047, 128), (2049, 128) (DIST_SYM_SHAPES) and the
   EMP table (jaccard_packed == jaccard there too). Euclidean (on the
   tensor cores in three TF32 products) against a float64 oracle of the
   Gram form at (2047, 128) and the EMP table: within twice the plain f32
   version's error, while a TF32 torch.matmul stand-in (the plain version
   with TF32 on) misses that bar.
6. The features path at the EMP shape through the entry point a user
   calls: pipeline(features, Bray-Curtis, 3,999 permutations, seed 0),
   once with a 6 GiB matrix budget (the planner picks the dense bridge:
   one braycurtis launch) and once with 3 GiB (the stream bridge: one
   launch per 256-row slab, 99), each launching the brute kernel twice
   and nothing else; F of the two bridges and of phase 3's engine.run
   (same seed, so the same labels) agree at rtol=1e-4 with p equal; each
   run's peak device memory above its start is logged. Then each other
   distance kernel's own path, the dense bridge at 999 permutations for
   euclidean (and aitchison), jaccard and jaccard with packed=1, whose F
   must equal the float jaccard's bit for bit.
7. Each distance kernel timed at the main path's shapes, (n, n, 128) for
   the dense bridge (the whole-table call, each pair once; the
   rectangular call on a clone logged beside it) and the (256, n, 128)
   slab x 99 for the stream bridge, beside its plain version, torch.cdist
   for euclidean (the one PyTorch call that computes one of these
   functions; the kernel must not be slower), for scale beside jaccard its
   intersection alone as one bf16 torch.matmul of the 0/1 table with its
   transpose, its bound (each pair once for the whole-table call) and its
   own floor (FP32 instructions for braycurtis, popcounts for
   jaccard_packed, the tensor-core product of its exact form for
   euclidean and jaccard; a time under it fails the run).
8. The fused distance -> s_W kernel against its plain version on the card
   for euclidean, braycurtis and jaccard (on presence data), each a
   whole-table call (the kernel's symmetric visit of the tiles j >= i),
   at (n, d, P, G) = (57, 3, 1, 3), (130, 37, 5, 2), (2047, 128, 37, 8),
   at ragged n on both sides of a 16-tile strip's end with P on both
   sides of a 128-permutation pass (FUSED_SYM_SHAPES) and at (2047, 128,
   261, 8): s_W and row sums at rtol=2e-4, atol=1e-5 (the reference's own
   bar); at (2047, 128, 261, 8), 300-row slabs at their offsets (the full
   visit at 1/2) must sum (s_W) and concatenate (row sums) to the full
   call at rtol=1e-4, as must the slabs of the table zero-padded to 2,400
   rows (n_valid = 2047, so the last slab is all pad rows and must give
   zeros) and the padded table in one call (the symmetric visit past
   n_valid), each also against the plain version on the padded table at
   the reference's bar; 16 + 16 + 5 and 128 + 128 + 5 permutations must
   give the one call at rtol=1e-6; at the EMP shape P = 156 and the
   plan's chunk (fused_plan) of s_W must match the plain version within
   SW_MAIN_RTOL.
9. The features path at the EMP shape with the DEFAULT budgets:
   pipeline(features, Bray-Curtis, 3,999 permutations, seed 0), which the
   planner sends to the fused-kernel bridge (not even one (n, n) buffer
   fits 1 GiB) in chunks its plan sizes by the kernel's workset
   (fused_plan: 896 permutations, 5 launches): fused_sw launched once a
   chunk and no other kernel, F within rtol=1e-4 of phase 3's engine.run and of
   phase 6's dense bridge with p equal, its null within what f32 s_W
   allows of the dense bridge's (see SW_MAIN_RTOL), and a peak of device
   memory above the call's start under the 1 GiB matrix budget (4 n^2 =
   2.53 GB would not fit). Then the two-stage fused bridge at 999
   permutations: 99 braycurtis slab launches and no other kernel, F
   within rtol=1e-4 and the null within the same f32 allowance of the
   dense bridge's first 1,000, and its p theirs.
10. The fused kernel timed at (n, d, G) = (25145, 128, 8) at the plan's
   chunk (the main path's shape), at P = 156 (every earlier time's) and
   at P = 1 (the feature phase and one 128-permutation pass), each beside
   its bound (each pair once), its own floors (the feature phase at the
   f32 peak and one INT32 compare per (pair, permutation), as brute's; a
   time under the larger fails the run), its plain version and, for
   scale, one f32 torch.matmul of a resident mat2 with the chunk's (n, P
   G) one-hot factor (the contraction alone: no PyTorch call computes
   features -> s_W, so no library time); and the label draw of one chunk.
11. The dense-design fused kernel (fused_sw_cols) against its plain
   version on the card for euclidean, braycurtis and jaccard (on presence
   data) at (n, d, P, K) = (57, 3, 1, 3), (130, 37, 5, 10), (2047, 128,
   37, 10), on permuted design bases (core.design.build): s_cols and row
   sums at rtol=2e-4, atol=1e-5; at n = 2047, 300-row offset slabs of the
   table padded to 2,400 rows (n_valid = 2047, so the last slab is all pad
   rows and must give zeros) sum to the full call at rtol=1e-4, as does
   the padded table in one call (the symmetric visit past n_valid), and 16 +
   16 + 5 permutations give the 37-permutation call at rtol=1e-6; every
   feature mode at (n, d, P, K) = (331, 24, 261, 1) (odd n, K = 1, P * K
   past two 128-q passes), the whole table (the kernel's symmetric visit of
   the tiles j >= i) and a row slab at offset 97, at those bars and within
   SW_MAIN_RTOL * s_T; at the EMP design chunk (cols_plan: P = 204, K =
   10) every
   s_cols entry within
   SW_MAIN_RTOL * s_T of the plain version, and the plain version with
   TF32 matmuls (a lower-precision stand-in) outside that bar.
12. The design path at the EMP shape with the DEFAULT budgets:
   pipeline(features, Bray-Curtis, 3,999 permutations, seed 0) with
   synthetic_design(25145, ("age", "depth"), 4 strata, seed 0) columns:
   (a) covariates, (b) covariates + weights, (c) strata only, (d)
   covariates + strata. (a), (b) and (d) must launch fused_sw_cols 20
   times (one per chunk of cols_plan, 204) and nothing else, (c) fused_sw
   once per chunk of the strata draw's plan (strata_plan) and nothing
   else; each run's
   peak device memory above its
   start stays under the 1 GiB matrix budget. (a) and (c) run again
   through the dense bridge (6 GiB budget, same seed): per-term observed
   F at rtol=1e-4, each null F within the f32 allowance of
   design_null_allowance (from SW_MAIN_RTOL * s_T on each column's form),
   and p apart by at most the null F within that allowance of the
   observed F, over 4,000. Those bars must reject the covariate dense
   bridge run with TF32 matmuls (a lower-precision stand-in) in every
   term.
13. fused_sw_cols timed at the EMP design chunk beside its plain version,
   its bound and its own floors (its feature phase at the f32 peak and its
   three TF32 products at the dense TF32 peak, both over the symmetric
   half; a time under the larger fails the run), at P = 1 to split the
   feature phase from the
   permutation phase, and, for scale, one f32 torch.matmul of a resident
   mat2 with the chunk's (n, P*K) basis factor (the contraction only; no
   PyTorch call computes features -> per-column forms); and the rest of a
   design chunk: its index-permutation draw (free and within the 4
   strata) and its basis gather.
14. Each feature mode of both fused kernels against its plain version in
   the same mode (both sides see the same quantized values): bf16 and fp8
   for euclidean, braycurtis and jaccard (on presence data), packed for
   jaccard, at phase 8's and phase 11's check shapes (phase 8 / 11's bars)
   and at the EMP chunks, (n, d, P, G) = (25145, 128, the plan's chunk,
   8) and (n, d, P, K) = (25145, 128, 204, 10) (s_W within SW_MAIN_RTOL,
   s_cols within
   SW_MAIN_RTOL * s_T); packed equal to the f32 jaccard kernel on the same
   presence data bit for bit (s_W or s_cols, and row sums); the fp8 bytes
   the wrapper hands the kernel equal to core.distance's cast on the CPU
   (byte for byte the reference's); each mode's s_W drift from the f32
   kernel at the EMP chunk logged and held to the reference's bars on raw
   s_W against an fp64 oracle (2e-2 braycurtis and euclidean, 1e-5
   jaccard); and the f32 fused_sw_cols at the EMP design chunk within
   SW_MAIN_RTOL * s_T of an fp64 oracle (euclidean, jaccard), and the
   plain versions of both fused kernels ORACLE_MARGIN times inside their
   bars of it (s_cols within SW_MAIN_RTOL * s_T / 10, s_W within
   SW_MAIN_RTOL / 10 relative), each margin logged.
15. pipeline() at the EMP shape with the default budgets at a precision
   (fused_tuning = registry.precision_tuning(tag)): bf16 and fp8 on
   Bray-Curtis, packed on jaccard, and the covariate design at bf16, fp8
   and (jaccard) packed. Each launches its mode's kernel only,
   fused_sw[tag] once a chunk of the plan's or 25 fused_sw_cols[tag]. Each
   is held to the plain sweep at the same precision on the same labels,
   the dense bridge (6 GiB budget) on the table round-tripped through the
   mode: F at rtol=1e-4 with p equal and the null within phase 9's f32
   allowance,
   or per term phase 12's bars; packed F, p and nulls equal to those of
   the f32 jaccard run bit for bit. Each run's peak device memory above
   its start is logged and held under the 1 GiB matrix budget, and, less
   the run's feature copies (jaccard's presence table, the quantized
   table), under the 256 MiB label budget (the sweeps quantize the table
   once, not a launch).
16. Each mode's kernel timed at its EMP chunk and at P = 1 (fused_sw
   also at P = 156), beside its plain version (timed in phase 14), its
   floors (fused_sw: also its INT32 compares) and its bound counted both
   ways, by operations and by bytes at the mode's element width (4 / 2 /
   1 / 0.125 B a feature); then the STREAM probe (kernels/stream): copy,
   scale, add and triad at 2^28 f32 elements (1 GiB an array), each
   launched once through stream_op with its launch counted, checked
   against its plain form on the card bit for bit, and timed in turns
   with one PyTorch call of the same op (library, kernel, kernel,
   library, three rounds; their ratio logged) beside its byte bound,
   with its GB/s against the datasheet's 3.35 TB/s.
17. The fused-kernel bridge against its memory budget: pipeline() with
   the default budgets (256 MiB of label budget) at the EMP shape for
   labels, strata only and the K = 10 covariate design (3,999
   permutations), and for labels at n = 60,000 (999 permutations), each
   with its chunk, launches and end-to-end time; its device peak above
   the start, less the feature copies the run makes (none in f32: the
   table the caller passed is read in place), must stay within the budget
   (the kernels' partials of fixed slots, the draw's sub-blocks sized by
   what the workset and the slack leave). Then s_W, s_cols and s_T
   through the megakernel sweeps at the chunks of two budgets (256 and 48
   MiB, 1,000 slots), bit-equal.
18. Many-study runs: pipeline_many on 3 stacked EMP-shape studies
   (synthetic_study seeds 0-2; the 7.6 GB distance stack is over the
   1 GiB matrix budget, so 'auto' takes the fused-kernel bridge), labels
   and the K = 10 covariate design, each study's F null and p bit-equal
   to pipeline(x_s, seed=study_seed(0, s)) and the batch's peak (no
   feature copy in f32) within the budget; then permanova_many on a
   ragged batch of 6 studies (n = 1,500 ... 9,000, Bray-Curtis matrices
   from the distance kernel) with n_pad = 10,240 recorded, through brute
   only, each study's F null and p bit-equal to its engine.run (each
   ragged study runs on its own matrix, so this holds by construction).
   Their times are logged.
19. Autotune at the EMP shape (n = 25,145, 8 groups, 3,999
   permutations). Before any phase runs, REPRO_TORCH_AUTOTUNE_CACHE
   points at a file in a fresh temporary directory (removed at the end),
   so no winner outlives the run and phases 1-18 plan from the
   heuristics. engine.run(autotune=True) times brute, permblock and
   matmul (each its hand kernel: a warm-up call, then the median of 3 by
   CUDA events, on 1,024 permutations); each candidate's median and the
   winner are printed; F within rtol=1e-4 of phase 3's heuristic run
   with p equal; the shoot-out launches each kernel 4 times and the run
   its winner once a chunk; the EMP test pinned to brute and to tiled is
   timed in turns beside it (logged). A second tuned call on a fresh view of the
   file reads the persisted entry and measures nothing (the shoot-out
   count), and a plain plan names the persisted winner. Then
   pipeline(autotune=True) on the dense bridge (6 GiB budget): the
   stage-1 shoot-out (braycurtis.cuda, its one candidate) persisted, F
   and p as phase 3's. The cache then points at an empty file again.
20. Ordination at full width: pipeline(EMP features, ordination=3) on the
   default fused-kernel bridge (pcoa_features: every matvec rebuilds the
   (256, n) Bray-Curtis slabs through the distance kernel; launches
   counted: the sweep's fused_sw and one slab sweep per matvec) and on
   the stream bridge (3 GiB budget; pcoa_subspace on its mat2), each with
   its time and subspace iterations, the two embeddings within the
   reference's bridge bar (rtol 2e-3, sign-aligned). At n = 8,192
   (synthetic_study seed 1), pcoa_subspace and pcoa_features against
   pcoa_eigh (cuSOLVER, f32) and a float64 torch.linalg.eigh oracle on
   the card: eigenvalues and sign-aligned coordinates within rtol 2e-4
   (the reference's bar), explained == eigvals / s_T. (The dense bridge's
   eigh at n = 25,145 is a probe of its own: scripts/pcoa_eigh_probe.py.)
21. Out of core (pipeline() on a data.slabcache cache; the caches live in
   a temporary directory removed at the end). (a) At (n, d, slab_rows) =
   (2500, 512, 256), a ragged last slab of 196: for every metric (jaccard
   f32 from a dense cache, packed from a csr cache) the row slabs
   streaming.ooc_mat2_row_blocks assembles from (slab, slab) distance
   tiles equal mat2_row_blocks' slabs of the resident table bit for bit,
   the distance kernel launched once a tile. At d = 16,384 (at 512 the
   sweep's own footprint exceeds the table, so no budget both forces
   'host' and holds it), pipeline(cache) at a device budget one byte under
   the table ('host') equals the in-memory fused bridge at row_block = 256
   bit for bit (F, p, s_T, the null; per term), every metric, both forms
   (fused, fused-kernel), labels, labels within 4 strata and the design
   of two covariates and 4 strata; jaccard f32 and packed from a csr
   cache against the presence table; and the 'hbm' short circuit equals
   the resident run. (b) The realistic cell:
   synthetic_sparse_counts(25145, 16384, density 0.1, seed 0, slab_rows
   2048), 1,647,902,720 B of dense f32 in 13 slabs (12 x 2,048 + 569),
   device budget 1.5 GiB (under the table: 'host'); Bray-Curtis labels at
   3,999 permutations, the covariate design (K = 10) at 999 and Aitchison
   labels at 999 (clr in place on each fetched slab). Each prints its
   end to end, sweep and stall times, and must read
   ooc_disk_traffic_bytes(13, table) = 23,070,638,080 B (182 fetches),
   launch its distance kernel (braycurtis; euclidean for aitchison) 169
   times and nothing else, and keep its device peak above the start
   (allocated, and reserved from an emptied cache) within the plan's
   modelled peak (planner.ooc_peak_bytes), itself within 1.5 GiB; then
   F, p and the null equal the same table resident on the card through
   the fused bridge at row_block = 2,048 bit for bit. The host -> device
   GB/s of one 128 MiB slab from pinned and from pageable
   memory (CUDA events) is logged beside the host tier's model. Then one
   more Bray-Curtis labels sweep at 999 permutations is profiled for
   phase 22's idle share (here, before the cache is removed).
22. Telemetry (repro_torch.obs). (a) At the EMP shape, traced against
   untraced: pipeline(trace=<tmp>.json) on the labels fused-kernel bridge
   and the covariate design (default budgets) and on the stream bridge (3
   GiB), engine.run on the resident D inside obs.session(). F, p and
   every null F equal bit for bit; the exported JSON loads and its span
   tree (name, parent, depth) is the one the CPU parity tests expect for
   the path (tests/test_torch_obs.py); engine.perm_chunks, the
   fusedk.chunk or engine.sw_chunk spans and the kernel's launches agree,
   and every cuda.launches.* counter equals the run's LAUNCHES.
   obs.report() of the four runs is printed, and no stage of
   obs.stage_rows(backend="cuda") may read above 105% of the HBM peak (a
   guard on the traffic models). (b) The device idle share: one warm run
   of phase 3's engine.run, phase 6's dense and stream bridges, phase 9's
   labels path, phase 12's covariate design and phase 15's bf16 labels
   under torch.profiler (CPU and CUDA) with tracing on; from the exported
   Chrome trace, the window, the busy time (the union of kernel, memcpy
   and memset intervals on every stream), the idle share 1 - busy /
   window, the five device operations that took the most time and the
   three longest idle gaps, each with the innermost obs span open across
   it. A profile with fewer device kernels than the run's counted
   launches fails the phase.
23. Serving (repro_torch.serve). (a) Each s_W kernel on a study of n =
   3,000 (Bray-Curtis, the distance kernel) zero-padded to 4,096 whose pad
   rows carry the sentinel label G (one serving block's masked draw, 128
   permutations): against its plain version on the padded input and the
   same kernel on the unpadded study, rtol=1e-4, atol=1e-5. (b) The
   slice's entry point, `repro_torch.launch.serve permanova --batch 4
   --inject-death` (6 studies, n 18-40, 199 permutations, block 32):
   serial, coalesced (bit for bit, then a warm replay with no kernel build
   or load and no bucket miss) and with worker 0 killed after 2 blocks
   (bit for bit), the brute kernel only. (c) A card-sized stream by
   features (synthetic_study(n, 128, 8), Bray-Curtis, 999 permutations,
   block 128, power-of-two buckets): 12 requests with n over 1,500-9,000,
   a strata and a covariate-design request at n = 4,000
   (synthetic_design), and the EMP request (n = 25,145, 3,999
   permutations, bucket 32,768). Served serially (each request's wall
   time and launches: braycurtis once, brute once a 128-permutation
   block, none for the design's plain companion; requests/s and p50 / p99
   from serve.step spans; the device peak) and coalesced at max_batch 4
   (bit for bit the serial results); each result against the port's
   unpadded pipeline() on the dense bridge with the same seed (F at
   rtol=1e-4, p equal, each null F within the f32 allowance, per term for
   the design). One warm serial replay profiled as in phase 22: the idle
   share, and each request's host <-> device copies (bytes and ms of the
   memcpy events inside its serve.step range, beside the bytes the server
   must move). (d) On the EMP request: a worker death, a deadline that
   degrades it (its null the clean null's prefix, its CI holding the clean
   p) and checkpoints it, then a new server resuming the checkpoint and
   the first server's resume_degraded(): each bit for bit the clean
   serial result.

Prints, before the last line, a JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it exits with code 2.

Full-f32 matmuls: TF32 is switched off for torch.matmul and cuDNN below,
so the plain sw_matmul, the plain fused version and the library call run
in f32, as the reference's f32 modes do.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

EMP_N, EMP_FEATURES, EMP_GROUPS, EMP_PERMS = 25145, 128, 8, 3999
CROSS_PERMS = 999
# (400, 3, 300) takes the matmul kernel through two 256-column slices of
# one permutation; (100, 7, 1) is one group
CHECK_SHAPES = [(57, 1, 3), (130, 5, 2), (2047, 37, 8), (400, 3, 300),
                (100, 7, 1)]
# the brute kernel's 64-row bands, 64-column tiles and 128-permutation
# blocks, each edge met from both sides (and G past a byte)
BRUTE_EDGE_SHAPES = [(63, 129, 4), (64, 128, 2), (65, 130, 5),
                     (127, 255, 8), (129, 257, 8), (333, 5, 300)]
# the permblock kernel's 64-row bands, 16-tile strips (n = 64 * 16 * k)
# and 128-permutation passes, each edge met from both sides (and G past a
# byte)
PERMBLOCK_EDGE_SHAPES = [(63, 129, 4), (64, 128, 2), (65, 127, 5),
                         (1023, 127, 5), (1024, 128, 8), (1025, 129, 8),
                         (2047, 257, 8), (2048, 1, 3), (2049, 129, 300)]
RTOL, ATOL = 1e-4, 1e-5
# At the EMP shape the part of s_W that depends on the permutation is
# s_A / s_T ~ (G - 1) / (n - 1) ~ 2.8e-4 of it, so rtol 1e-4 on s_W would
# pass a neighbouring permutation's s_W. Each kernel's s_W is held to its
# plain version at 1e-6 relative there (a few f32 ulps; neighbouring null
# s_W differ by ~1e-4), and two impls' null F to what that allows:
# |dF| <= 2 * SW_MAIN_RTOL * (F + (n - G) / (G - 1)), since
# F = (n - G) / (G - 1) * (s_T / s_W - 1).
SW_MAIN_RTOL = 1e-6
# how far inside a kernel's bar its plain version (the oracle the kernel
# is held to) must sit of fp64 at the EMP chunks
ORACLE_MARGIN = 10
KERNEL_OF = {"brute": "brute", "tiled": "permblock", "matmul": "matmul"}
# the phase-3 run whose launches a kernel's row reports: the auto run for
# brute (the planner's pick), the pinned run of its impl for the others
PATH_OF = {"brute": "auto", "permblock": "tiled", "matmul": "matmul"}
BF16_F64_RTOL = 5e-3
REPLACES = {
    "brute": "src/repro/kernels/permanova_sw/kernel.py:75",
    "permblock": "src/repro/kernels/permanova_sw/kernel.py:122",
    "matmul": "src/repro/kernels/permanova_sw/kernel.py:174",
}
SOURCE = "src/repro_torch/kernels/permanova_sw/csrc/permanova_sw.cu"
DIST_SOURCE = "src/repro_torch/kernels/distance/csrc/distance.cu"
DIST_REPLACES = {
    "braycurtis": "src/repro/kernels/distance/kernel.py:52",
    "jaccard": "src/repro/kernels/distance/kernel.py:105",
    "jaccard_packed": "src/repro/kernels/distance/kernel.py:168",
    "euclidean": "src/repro/kernels/distance/kernel.py:219",
}
DIST_CHECK_SHAPES = [(57, 57, 3), (130, 130, 37), (2047, 2047, 128),
                     (256, EMP_N, EMP_FEATURES)]
# whole-table calls (the distance kernels' symmetric visit of the 128 x
# 128 tiles j >= i) against the rectangular call on a clone of the table:
# ragged n on both sides of a tile edge, 16 tiles, and the EMP table
DIST_SYM_SHAPES = [(57, 3), (130, 37), (2047, 128), (2049, 128)]
# the CUDA-core distance kernels' own floors: FP32 instructions at 128
# lanes a clock on each SM (braycurtis issues 2 per (pair, feature)), and
# for jaccard_packed the popcount, 16 a clock on each SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0), one per (pair, word)
FP32_LANES_PER_SM, POPC_PER_SM = 128, 16
DIST_OWN_INSTR = {"braycurtis": 2, "jaccard_packed": 1}
# the tensor-core distance kernels' products in their exact forms: (products
# of 2 operations per (pair, feature), the dense peak of their type):
# euclidean three TF32 products, jaccard one int8 product
DIST_TC_PRODUCT = {"euclidean": (3, "tf32"), "jaccard": (1, "int8")}
GIB = 1024 ** 3
# matrix budgets that make the planner pick each bridge at the EMP shape:
# 8 n^2 = 4.71 GiB (D + mat2) fits 6 GiB; 4 n^2 = 2.36 GiB fits 3 GiB
BRIDGE_BUDGETS = {"dense": 6 * GIB, "stream": 3 * GIB}
STREAM_ROWS = 256       # the planner's row block at the EMP shape
# each other distance kernel's own path: (metric, dist_tuning, kernel)
OTHER_PATHS = [("euclidean", None, "euclidean"),
               ("aitchison", None, "euclidean"),
               ("jaccard", None, "jaccard"),
               ("jaccard", {"packed": 1}, "jaccard_packed")]
FUSED_SOURCE = "src/repro_torch/kernels/fused_sw/csrc/fused_sw.cu"
FUSED_REPLACES = "src/repro/kernels/fused_sw/kernel.py:193"
FUSED_CHECK_SHAPES = [(57, 3, 1, 3), (130, 37, 5, 2), (2047, 128, 37, 8)]
# whole-table calls (the kernel's symmetric visit of the tiles j >= i) at
# ragged n on both sides of a strip end (16 column tiles: n = 1,024) and P
# on both sides of a 128-permutation pass
FUSED_SYM_SHAPES = [(331, 24, 127, 8), (331, 24, 129, 300),
                    (1023, 16, 128, 5), (1025, 16, 257, 8), (1089, 8, 29, 3)]
# offset slabs and permutation splits: 261 permutations, 300-row slabs
FUSED_SPLIT_SHAPE = (2047, 128, 261, 8)
FUSED_RTOL = 2e-4       # the reference's bar (tests/test_fused_sw.py:60)
SLAB_RTOL = 1e-4        # offset slabs against the full call (:95)
SLAB_ROWS = 300
PAD_ROWS = 2400    # the n = 2047 table padded so its last slab is all pad
# chunk invariance: the first 37 permutations in three calls, and all 261
# in calls of whole and partial 128-permutation passes
SPLITS = ((16, 16, 5), (128, 128, 5))
SPLIT_RTOL = 1e-6
# the fused_sw chunk the one-hot model gives at the EMP shape, 256 MiB /
# (4 n (2 G + 1)): every earlier time of the kernel was taken at it, so
# phases 10 and 16 time it there too, beside the plan's chunk (fused_plan)
ONEHOT_CHUNK = 156
DEFAULT_MATRIX_BUDGET = GIB
COLS_REPLACES = "src/repro/kernels/fused_sw/kernel.py:338"
COLS_CHECK_SHAPES = [(57, 3, 1, 3), (130, 37, 5, 10), (2047, 128, 37, 10)]
# every mode of fused_sw_cols at an odd n, K = 1 and P * K past two 128-q
# passes (not a multiple of one), symmetric and as a row slab at an offset
COLS_ODD = (331, 24, 261, 1)
COLS_ODD_SLAB = (97, 251)
# the design path at the EMP shape: K = 1 + 2 covariates + (G - 1) = 10
# basis columns; the card's plan sizes its chunk by fused_sw_cols' workset
# (cols_plan: 204, so 4,000 slots take 20 launches)
DESIGN_COVARIATES = ("age", "depth")
DESIGN_STRATA = 4
DESIGN_K = 10
# phase 4: the rows of one draw sub-block at which each kind of draw is
# held to its memory model and timed
DRAW_MODEL_ROWS = (1, 4, 17, 45, 91, 107)
# phase 17: labels at this n, where the earlier layout planned a 271 MiB
# workset at the 256 MiB budget
BUDGET_N = 60000
# phase 18: stacked EMP-shape studies, and a ragged batch of single EMP
# sub-study sizes with the reference's bucket width
MANY_STUDIES = 3
RAGGED_SIZES = (1500, 3000, 4500, 6000, 7500, 9000)
RAGGED_PAD = 10240
# the feature modes (phases 14-16): the metrics each runs on, and the
# reference's bars for a mode's raw s_W against an fp64 oracle
# (tests/test_precision.py:197), held here against the f32 kernel
MODE_METRICS = {"bf16": ("braycurtis", "euclidean", "jaccard"),
                "fp8": ("braycurtis", "euclidean", "jaccard"),
                "packed": ("jaccard",)}
MODE_DRIFT = {"braycurtis": 2e-2, "euclidean": 2e-2, "jaccard": 1e-5}
# the metric of each mode's main path (phase 15) and timing (phase 16)
MODE_PATH_METRIC = {"bf16": "braycurtis", "fp8": "braycurtis",
                    "packed": "jaccard"}
MODE_BYTES = {"f32": 4.0, "bf16": 2.0, "fp8": 1.0, "packed": 0.125}
STREAM_SOURCE = "src/repro_torch/kernels/stream/csrc/stream.cu"
STREAM_REPLACES = "src/repro/kernels/stream/kernel.py:35"
STREAM_N = 2 ** 28          # 1 GiB of f32 an array
STREAM_SCALAR = 3.0
# rounds of (library, kernel, kernel, library), 10 launches each: the
# kernel and PyTorch's call differ by ~0.5%, about one window's noise
STREAM_ROUNDS = 3
# dense tensor-core peaks (NVIDIA's H100 SXM data sheet) for the matmul
# kernel's one-hot floors; H100_SXM carries bf16's
TC_TF32, TC_BF16, TC_INT8 = 495e12, 989e12, 1979e12
TC_PEAK = {"tf32": TC_TF32, "int8": TC_INT8}
# the brute kernel's own floor: one INT32 compare per (pair, permutation)
# at 64 lanes a clock on each of the 132 SMs, at the 1.98 GHz boost clock
INT32_LANES_PER_SM, SMS, BOOST_HZ = 64, 132, 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def fused_plan() -> tuple:
    """(chunk, launches) of fused_sw on the main path: the planner's chunk
    at the EMP shape with the default budgets on the card (the whole
    number of the kernel's 128-permutation passes of least modelled time
    whose workset, partials and labels, the label draw and the slack fit
    the 256 MiB label budget) and the launches for the EMP_PERMS + 1
    slots."""
    from repro_torch.pipeline import planner
    chunk = planner.plan_pipeline(
        EMP_N, EMP_FEATURES, EMP_PERMS + 1, EMP_GROUPS, backend="cuda",
        metric="braycurtis").sw.chunk
    return chunk, -(-(EMP_PERMS + 1) // chunk)


@functools.lru_cache(maxsize=None)
def cols_plan() -> tuple:
    """(chunk, launches) of fused_sw_cols on the design path: the
    planner's chunk at the EMP shape, K = DESIGN_K, with the default
    budgets on the card (the kernel's workset, partials, index and
    basis, with the index draw and the slack in the 256 MiB label
    budget, whole 128-q passes) and the launches for the EMP_PERMS + 1
    slots."""
    from repro_torch.pipeline import planner
    chunk = planner.plan_pipeline(
        EMP_N, EMP_FEATURES, EMP_PERMS + 1, EMP_GROUPS, backend="cuda",
        metric="braycurtis", design_cols=DESIGN_K).sw.chunk
    return chunk, -(-(EMP_PERMS + 1) // chunk)


@functools.lru_cache(maxsize=None)
def strata_plan() -> tuple:
    """(chunk, launches) of fused_sw on a strata-only design at the EMP
    shape with the default budgets on the card: fused_plan's, with the
    strata draw's sub-blocks charged to the budget."""
    from repro_torch.pipeline import planner
    chunk = planner.plan_pipeline(
        EMP_N, EMP_FEATURES, EMP_PERMS + 1, EMP_GROUPS, backend="cuda",
        metric="braycurtis", draw="strata").sw.chunk
    return chunk, -(-(EMP_PERMS + 1) // chunk)


def feature_copies(x, metric: str, tuning=None) -> int:
    """Bytes of the feature copies a fused-kernel run on the table x
    makes: the metric's prepared table where preparing copies (jaccard's
    presence floats; Bray-Curtis reads the caller's table in place) and
    the table quantized at the precision of `tuning` (none in f32)."""
    from repro_torch.core import distance
    from repro_torch.pipeline import registry
    n, d = x.shape
    xp = distance.ROW_METRICS[metric].prepare(x)
    prepared = 0 if xp.data_ptr() == x.data_ptr() else 4 * n * d
    t = tuning or {}
    if registry.precision_tag(t) == "f32":
        return prepared
    return prepared + int(registry.feat_element_bytes(t) * n * d)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel_err(got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())


def cuda_ms_once(fn, warm) -> tuple:
    """(ms, result) of one fn() call by CUDA events, after a warm-up call
    of `warm` (e.g. fn at a small shape): a slow plain version timed on
    the same call whose result is checked."""
    import torch
    warm()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def cuda_ms(fn, reps: int, warm=None) -> float:
    """Mean ms of fn() over reps, by CUDA events, after one warm-up call
    (of `warm` if given, e.g. the same function at a small shape)."""
    import torch
    (warm or fn)()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def random_instance(n, p, g, seed, device):
    import numpy as np
    import torch
    from repro_torch.core import permutations
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    gperms = np.stack([rng.permutation(grouping) for _ in range(p)])
    gperms[0] = grouping
    mat2 = torch.from_numpy(d * d).to(device)
    labels = torch.from_numpy(gperms.astype(np.int32)).to(device)
    inv_gs = permutations.inv_group_sizes(
        torch.from_numpy(grouping).to(device), g)
    return mat2, labels, inv_gs


def bound_ms(mat2, labels, inv_gs, chip) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time this card could take
    for s_W on these inputs — each input read once and the output written
    once at the HBM rate, against the operations these labels need at the
    peak rate for the inputs' type. Every variant computes the same
    function, so all have this bound, whatever their own formulation does
    (the matmul kernel's one-hot form does 2 n^2 P G FLOP, logged
    beside it)."""
    import torch
    n, p, g = mat2.shape[0], labels.shape[0], inv_gs.shape[0]
    nbytes = (mat2.numel() * mat2.element_size() + labels.numel() * 4
              + g * 4 + p * 4)
    # a label compare per (pair, perm) and an add per matching pair; group
    # sizes are kept under permutation, so matches are counted from the
    # observed sizes
    sizes = torch.bincount(labels[0].long(), minlength=g).double()
    matches = float((sizes * (sizes - 1) / 2).sum())
    ops_ = p * (n * (n - 1) / 2 + matches)
    rate = chip.peak_flops_bf16 if mat2.dtype == torch.bfloat16 \
        else chip.peak_flops_f32
    t_bytes = nbytes / chip.hbm_bandwidth * 1e3
    t_ops = ops_ / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def onehot_flop(labels, inv_gs) -> float:
    """FLOP of the matmul kernel's one-hot formulation, 2 n^2 P G: more
    than the function needs, so not its bound."""
    n, p = labels.shape[1], labels.shape[0]
    return 2.0 * n * n * p * inv_gs.shape[0]


def phase_header():
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.fused_sw import ops as fops
    from repro_torch.kernels.permanova_sw import ops
    from repro_torch.kernels.stream import ops as sops
    log(f"[smoke] card: {card_line()}")
    log(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # one nvcc per source, started together
    with ThreadPoolExecutor(4) as pool:
        libs = [f.result() for f in [pool.submit(m.load_library)
                                     for m in (ops, dops, fops, sops)]]
    log(f"[smoke] kernel build+load {time.perf_counter() - t0:.2f}s "
        f"({ops.SOURCE.name} -> {ops._build.library_path(ops.SOURCE).name}, "
        f"{dops.SOURCE.name} -> {dops._build.library_path(dops.SOURCE).name}"
        f", {fops.SOURCE.name} -> "
        f"{fops._build.library_path(fops.SOURCE).name}, {sops.SOURCE.name} "
        f"-> {sops._build.library_path(sops.SOURCE).name}) config "
        f"{ops.kernel_config(libs[0])} {fops.kernel_config(libs[2])} "
        f"{fops.cols_kernel_config(libs[2])}")


def phase_kernels(dev):
    import torch
    from repro_torch.core import fstat
    from repro_torch.kernels.permanova_sw import ops, ref
    worst = {v: 0.0 for v in ops.VARIANTS}
    for n, p, g in CHECK_SHAPES:
        mat2, labels, inv_gs = random_instance(n, p, g, n + p + g, dev)
        plain = ref.sw_ref(mat2, labels, inv_gs)
        for v in ops.VARIANTS:
            got = ops.permanova_sw(mat2, labels, inv_gs, variant=v)
            torch.cuda.synchronize()
            err = rel_err(got, plain)
            worst[v] = max(worst[v], err)
            check(torch.allclose(got, plain, rtol=RTOL, atol=ATOL)
                  and (v == "matmul" or err <= SW_MAIN_RTOL),
                  f"{v} kernel != sw_ref at {(n, p, g)}: rel {err:.3e}")
            log(f"[smoke] kernel {v:9s} f32  (n,P,G)={(n, p, g)} "
                f"max_rel_err={err:.3e} vs sw_ref")
        plain_mm = fstat.sw_matmul(mat2, labels, inv_gs)
        check(torch.allclose(plain_mm, plain, rtol=RTOL, atol=ATOL),
              f"plain sw_matmul != sw_ref at {(n, p, g)}")
        m16 = mat2.to(torch.bfloat16)
        got = ops.permanova_sw(m16, labels, inv_gs, variant="matmul")
        torch.cuda.synchronize()
        same_in = ref.sw_ref(m16.float(), labels,
                             ops._rounded_sqrt_w(inv_gs, m16.dtype) ** 2)
        err_same = rel_err(got, same_in)
        ref64 = torch.from_numpy(ref.sw_ref_f64(mat2, labels, inv_gs))
        err64 = rel_err(got.double().cpu(), ref64)
        check(torch.allclose(got, same_in, rtol=RTOL, atol=ATOL),
              f"bf16 matmul != sw_ref(bf16 operands) at {(n, p, g)}: "
              f"rel {err_same:.3e}")
        check(err64 < BF16_F64_RTOL,
              f"bf16 matmul vs f64 reference at {(n, p, g)}: rel {err64}")
        log(f"[smoke] kernel matmul    bf16 (n,P,G)={(n, p, g)} "
            f"max_rel_err={err_same:.3e} vs sw_ref(bf16 operands), "
            f"{err64:.3e} vs f64 reference")
    for n, p, g in BRUTE_EDGE_SHAPES:
        mat2, labels, inv_gs = random_instance(n, p, g, n + p + g, dev)
        got = ops.permanova_sw(mat2, labels, inv_gs, variant="brute")
        plain = ref.sw_ref(mat2, labels, inv_gs)
        torch.cuda.synchronize()
        err = rel_err(got, plain)
        worst["brute"] = max(worst["brute"], err)
        check(err <= SW_MAIN_RTOL,
              f"brute kernel != sw_ref at the tile edge {(n, p, g)}: rel "
              f"{err:.3e} (limit {SW_MAIN_RTOL})")
        log(f"[smoke] kernel brute     f32  (n,P,G)={(n, p, g)} "
            f"max_rel_err={err:.3e} vs sw_ref (tile edges)")
    for n, p, g in PERMBLOCK_EDGE_SHAPES:
        mat2, labels, inv_gs = random_instance(n, p, g, n + p + g, dev)
        got = ops.permanova_sw(mat2, labels, inv_gs, variant="permblock")
        plain = ref.sw_ref(mat2, labels, inv_gs)
        plain64 = ref.sw_ref(mat2.double(), labels, inv_gs.double())
        torch.cuda.synchronize()
        err, err64 = rel_err(got, plain), rel_err(got.double(), plain64)
        worst["permblock"] = max(worst["permblock"], err)
        check(err <= SW_MAIN_RTOL and err64 <= SW_MAIN_RTOL,
              f"permblock kernel at the tile edge {(n, p, g)}: rel {err:.3e} "
              f"vs sw_ref, {err64:.3e} vs float64 (limit {SW_MAIN_RTOL})")
        log(f"[smoke] kernel permblock f32  (n,P,G)={(n, p, g)} "
            f"max_rel_err={err:.3e} vs sw_ref, {err64:.3e} vs float64 "
            f"(band, strip and pass edges)")
    return worst


def zero_launches():
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.fused_sw import ops as fops
    from repro_torch.kernels.permanova_sw import ops
    from repro_torch.kernels.stream import ops as sops
    for counts in (ops.LAUNCHES, dops.LAUNCHES, fops.LAUNCHES,
                   sops.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    """Every kernel's launches since zero_launches(), by kernel name (a
    fused kernel's mode as 'fused_sw[fp8]', a STREAM op as
    'stream.triad')."""
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.fused_sw import ops as fops
    from repro_torch.kernels.permanova_sw import ops
    from repro_torch.kernels.stream import ops as sops
    return {**ops.LAUNCHES, **dops.LAUNCHES, **fops.LAUNCHES,
            **{f"stream.{k}": v for k, v in sops.LAUNCHES.items()}}


def phase_main_path(dev):
    """The paper's EMP shape through the entry points a user calls. Returns
    mat2, the labels' device copy, each run's own launch counts, the auto
    run's (F, p) and the study (features, labels) as numpy arrays."""
    import torch
    from repro_torch import engine
    from repro_torch.core import permutations
    from repro_torch.core.distance import (distance_matrix,
                                           validate_distance_matrix)
    from repro_torch.data.microbiome import synthetic_study
    from repro_torch.engine import planner
    from repro_torch.kernels.permanova_sw import ops

    x, grouping = synthetic_study(EMP_N, EMP_FEATURES, EMP_GROUPS,
                                  effect_size=1.0, seed=0)
    t0 = time.perf_counter()
    dm = distance_matrix(torch.from_numpy(x).to(dev), "braycurtis")
    checks = validate_distance_matrix(dm)
    torch.cuda.synchronize()
    t_dm = time.perf_counter() - t0
    check(checks["ok"], f"distance matrix checks failed: {checks}")
    log(f"[smoke] EMP distance matrix n={EMP_N} d={EMP_FEATURES} "
        f"braycurtis {t_dm:.3f}s checks={checks}")

    zero_launches()
    t0 = time.perf_counter()
    res = engine.run(dm, torch.from_numpy(grouping), n_perms=EMP_PERMS,
                     impl="auto", seed=0, device=dev)
    f_stat, p_value = float(res.f_stat), float(res.p_value)   # waits
    t_test = time.perf_counter() - t0
    paths = {"auto": dict(ops.LAUNCHES)}
    log(f"[smoke] EMP plan: {res.plan}")
    log(f"[smoke] EMP permutation test {t_test:.3f}s "
        f"({(EMP_PERMS + 1) / t_test:.1f} perms/s) F={f_stat:.6g} "
        f"p={p_value:.6g} launches={paths['auto']}")
    check(res.plan.startswith("brute[brute kernel] stream(")
          and res.plan.endswith("chunks=2"),
          f"expected the brute kernel in 2 streamed chunks, got "
          f"{res.plan!r}")
    check(paths["auto"] == {"brute": 2, "permblock": 0, "matmul": 0},
          f"each chunk must launch the brute kernel once: {paths['auto']}")
    check(res.f_perms.is_cuda and res.f_perms.shape == (EMP_PERMS + 1,)
          and bool(torch.isfinite(res.f_perms).all()),
          "null distribution must be finite, (n_perms + 1,), on the card")
    check(0.0 < p_value <= 1.0 and f_stat > 0.0, "F/p out of range")

    g_dev = torch.from_numpy(grouping).to(dev)
    perms = permutations.permutation_batch(g_dev, 0, CROSS_PERMS + 1, seed=1)
    cross = {}
    for impl in ("brute", "tiled", "matmul"):
        zero_launches()
        t0 = time.perf_counter()
        r = engine.run(dm, g_dev, n_perms=CROSS_PERMS, perms=perms,
                       impl=impl, device=dev)
        f_i, p_i = float(r.f_stat), float(r.p_value)
        dt = time.perf_counter() - t0
        paths[impl] = dict(ops.LAUNCHES)
        cross[impl] = (f_i, p_i, r.f_perms)
        log(f"[smoke] cross-impl {impl:6s} n_perms={CROSS_PERMS} {dt:.3f}s "
            f"({(CROSS_PERMS + 1) / dt:.1f} perms/s) F={f_i:.7g} p={p_i:.6g} "
            f"launches={paths[impl]} plan: {r.plan}")
        # the card's plan for this impl (tiled charges its partials)
        cross_chunks = -(-(CROSS_PERMS + 1) // planner.plan(
            EMP_N, CROSS_PERMS + 1, backend="cuda", impl=impl).chunk)
        want = {v: cross_chunks if v == KERNEL_OF[impl] else 0
                for v in ops.VARIANTS}
        check(paths[impl] == want,
              f"impl {impl} must launch only its kernel, once per chunk: "
              f"{paths[impl]} != {want}")
    f0, p0, null0 = cross["brute"]
    c = (EMP_N - EMP_GROUPS) / (EMP_GROUPS - 1)
    for impl, (f_i, p_i, null_i) in cross.items():
        check(abs(f_i - f0) <= RTOL * abs(f0),
              f"F of {impl} {f_i} != brute {f0} at rtol {RTOL}")
        check(p_i == p0, f"p of {impl} {p_i} != brute {p0}")
        tol = 2 * SW_MAIN_RTOL * (null0.abs() + c)
        excess = float(((null_i - null0).abs() / tol).max())
        check(excess <= 1.0,
              f"null F of {impl} differs from brute's by {excess:.3g}x the "
              f"f32 allowance 2*{SW_MAIN_RTOL}*(F + {c:.1f})")
        log(f"[smoke] cross-impl {impl:6s} null F vs brute: max "
            f"{float((null_i - null0).abs().max()):.3e} abs, "
            f"{excess:.3f} of the f32 allowance")
    mat2 = dm * dm
    del dm
    return mat2, g_dev, paths, (f_stat, p_value), (x, grouping)


def phase_timings(dev, mat2, g_dev, paths, worst):
    import torch
    from repro_torch.core import fstat, permutations
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.permanova_sw import ops, ref
    from repro_torch.engine import planner

    inv_gs = permutations.inv_group_sizes(g_dev, EMP_GROUPS)
    chunk = planner.chunk_for_budget(EMP_N, EMP_PERMS + 1)
    draw_checks(dev, g_dev, chunk)
    shapes = {"brute": chunk, "permblock": CROSS_PERMS + 1,
              "matmul": CROSS_PERMS + 1}
    rows, plain_at = [], {}
    for v in ops.VARIANTS:
        labels = permutations.permutation_batch(g_dev, 0, shapes[v], seed=0)
        small = labels[:2].contiguous()

        def kern(lab=labels, v=v):
            return ops.permanova_sw(mat2, lab, inv_gs, variant=v)

        if v == "matmul":
            def plain(lab=labels):
                return fstat.sw_matmul(mat2, lab, inv_gs)
        else:
            def plain(lab=labels):
                return ref.sw_ref(mat2, lab, inv_gs)
        got = kern()
        # the plain version is timed on the call whose result is checked
        plain_ms, want = cuda_ms_once(plain, warm=lambda: plain(small))
        if v != "matmul":
            plain_at[shapes[v]] = want    # the same labels for any variant
        err_abs = float((got - want).abs().max())
        err = rel_err(got, want)
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL)
              and err <= SW_MAIN_RTOL,
              f"{v} kernel != plain at the main-path shape: rel {err:.3e} "
              f"(limit {SW_MAIN_RTOL})")
        ms = cuda_ms(kern, reps=3 if v != "brute" else 2)
        # the library yardstick for all three: one torch.matmul of mat2
        # with the (n, P*G) one-hot factor of these labels
        e = fstat.onehot_perm_factors(labels, inv_gs, mat2.dtype)
        e2d = e.permute(1, 0, 2).reshape(EMP_N, -1).contiguous()
        del e
        library_ms = cuda_ms(lambda: torch.matmul(mat2, e2d), reps=3)
        del e2d
        b_ms, b_by = bound_ms(mat2, labels, inv_gs, H100_SXM)
        if v == "brute":
            floor_ms = brute_floor_ms(labels)
            check(ms > floor_ms and ms > b_ms,
                  f"brute {ms:.3f} ms reads under its floors ({floor_ms:.3f}"
                  f", {b_ms:.3f} ms): a count is wrong")
        rows.append({
            "name": f"permanova_sw.{v}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[v], "path": PATH_OF[v],
            "launches": paths[PATH_OF[v]][v],
            "launches_by_path": {k: c[v] for k, c in paths.items()},
            "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "shape": {"n": EMP_N, "P": shapes[v], "G": EMP_GROUPS},
            "max_rel_err": max(err, worst[v]),
        })
        log(f"[smoke] timing {v:9s} (n={EMP_N}, P={shapes[v]}, "
            f"G={EMP_GROUPS}) f32: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, library {library_ms} ms, bound {b_ms:.3f} ms ({b_by}); "
            f"max_abs_err {err_abs:.3e} max_rel_err {err:.3e}")
        if v == "matmul":
            rows[-1].update(matmul_bf16(mat2, labels, inv_gs, ms,
                                        library_ms))
        if v == "brute":
            log(f"[smoke] timing brute     (n={EMP_N}, P={shapes[v]}): "
                f"kernel/library {ms / library_ms:.3f}; its own floor (one "
                f"INT32 compare per (pair, permutation), {INT32_LANES_PER_SM}"
                f" lanes x {SMS} SMs at {BOOST_HZ / 1e9:.2f} GHz) "
                f"{floor_ms:.3f} ms, {floor_ms / ms * 100:.1f}% of the "
                f"kernel's time")
        if v == "permblock":
            rows[-1]["at_p"] = permblock_vs_brute(mat2, g_dev, inv_gs,
                                                  plain_at)
            rows[-1]["tiled_chunk"] = tiled_chunk_memory(mat2, g_dev, inv_gs)
    return rows


def permblock_vs_brute(mat2, g_dev, inv_gs, plain_at) -> list:
    """The permblock kernel (the paper's Algorithm 2: each staged tile for
    every permutation) and brute (Algorithm 3's re-streaming) on the same
    labels, timed in turns (brute, permblock, permblock, brute) at the
    tiled path's P = 1,000 and at brute's chunk, each beside its bound and
    its own floor (one INT32 compare per (pair, permutation), the same for
    both), and permblock within SW_MAIN_RTOL of the plain version there
    (plain_at: the plain s_W by P, from the rows above, same labels)."""
    from repro_torch.core import permutations
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.permanova_sw import ops
    out = []
    for p in sorted(plain_at):
        labels = permutations.permutation_batch(g_dev, 0, p, seed=0)
        got = ops.permanova_sw(mat2, labels, inv_gs, variant="permblock")
        err = rel_err(got, plain_at[p])
        check(err <= SW_MAIN_RTOL,
              f"permblock at the EMP shape, P = {p}: rel {err:.3e} vs the "
              f"plain version (limit {SW_MAIN_RTOL})")
        t = {"brute": [], "permblock": []}
        for v in ("brute", "permblock", "permblock", "brute"):
            t[v].append(cuda_ms(lambda v=v: ops.permanova_sw(
                mat2, labels, inv_gs, variant=v), reps=2))
        b_ms, _ = bound_ms(mat2, labels, inv_gs, H100_SXM)
        floor_ms = brute_floor_ms(labels)
        for v, ts in t.items():
            check(min(ts) > floor_ms and min(ts) > b_ms,
                  f"{v} {min(ts):.3f} ms at P = {p} reads under its floors "
                  f"({floor_ms:.3f}, {b_ms:.3f} ms): a count is wrong")
        log(f"[smoke] timing permblock vs brute (n={EMP_N}, P={p}, in "
            f"turns): permblock {t['permblock'][0]:.3f} / "
            f"{t['permblock'][1]:.3f} ms, brute {t['brute'][0]:.3f} / "
            f"{t['brute'][1]:.3f} ms, permblock/brute "
            f"{sum(t['permblock']) / sum(t['brute']):.3f}; bound {b_ms:.3f} "
            f"ms, own floor (INT32 compares) {floor_ms:.3f} ms, "
            f"{floor_ms / min(t['permblock']) * 100:.1f}% of permblock's "
            f"time; max_rel_err {err:.3e} vs the plain version")
        out.append({"P": p, "ms": t["permblock"], "brute_ms": t["brute"],
                    "bound_ms": b_ms, "max_rel_err": err})
    return out


def tiled_chunk_memory(mat2, g_dev, inv_gs) -> dict:
    """A tiled chunk on the card's plan (labels plus the permblock
    kernel's (blocks, chunk) partials charged against the label budget):
    the labels and the partials buffer a launch allocates (the kernel
    allocates nothing else) stay within that budget. The caching
    allocator's peak above the labels for the wrapper's whole call (the
    partials, torch.sum's output, and a cached block may be larger than
    asked for) is logged beside it."""
    import torch
    from repro_torch.core import permutations
    from repro_torch.engine import planner
    from repro_torch.kernels.permanova_sw import ops
    pl = planner.plan(EMP_N, EMP_PERMS + 1, backend="cuda", impl="tiled")
    budget = planner.label_budget()
    labels = permutations.permutation_batch(g_dev, 0, pl.chunk, seed=0)
    partials = ops.launch_partials(
        ops.load_library(), "permblock", mat2, labels, inv_gs,
        torch.cuda.current_stream().cuda_stream)
    partial_bytes = partials.numel() * partials.element_size()
    del partials
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.permanova_sw(mat2, labels, inv_gs, variant="permblock")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    label_bytes = labels.numel() * labels.element_size()
    total = label_bytes + partial_bytes
    chunks = -(-(EMP_PERMS + 1) // pl.chunk)
    check(total <= budget and chunks == 2,
          f"tiled chunk {pl.chunk}: labels + partials {total / 2**20:.2f} "
          f"MiB vs the {budget / 2**20:.0f} MiB label budget, {chunks} "
          f"chunks")
    log(f"[smoke] tiled chunk (n={EMP_N}, plan: {pl.describe()}): "
        f"{chunks} chunks of {pl.chunk}; labels {label_bytes / 2**20:.2f} "
        f"MiB + a launch's partials {partial_bytes / 2**20:.2f} MiB = "
        f"{total / 2**20:.2f} MiB of the {budget / 2**20:.0f} MiB budget "
        f"({budget - total} B left); the allocator's peak above the labels "
        f"for the wrapper's whole call {peak / 2**20:.2f} MiB")
    return {"chunk": pl.chunk, "chunks": chunks, "bytes": total,
            "budget_bytes": budget}


def brute_floor_ms(labels) -> float:
    """The brute kernel's own floor (its formulation's, not the
    function's bound): one INT32 compare per (pair, permutation) of the
    upper triangle at the INT32 pipe's rate on every SM at boost clock."""
    n, p = labels.shape[1], labels.shape[0]
    return p * n * (n - 1) / 2 / (INT32_LANES_PER_SM * SMS * BOOST_HZ) * 1e3


def onehot_floors(labels, inv_gs, bf16) -> dict:
    """The matmul kernel's own floors for its one-hot form (not the
    function's bound): its tensor-core products, two TF32 (f32 mat2) or
    one bf16 of 2 n^2 P G FLOP each, at the dense peak of their type, and
    the mat2 bytes of its ceil(P / PB) passes at the HBM rate."""
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.permanova_sw import ops
    n, p, g = labels.shape[1], labels.shape[0], inv_gs.shape[0]
    cfg = ops.kernel_config(ops.load_library())
    pb = max(1, min(cfg["matmul_columns"] // g,
                    cfg["matmul_max_perm_block"]))
    passes = -(-p // pb)
    flop = onehot_flop(labels, inv_gs)
    return {"onehot_flop": flop,
            "onehot_products": 1 if bf16 else 2,
            "onehot_ops_floor_ms": (flop / TC_BF16 if bf16
                                    else 2 * flop / TC_TF32) * 1e3,
            "onehot_passes": passes,
            "onehot_bytes_floor_ms": passes * n * n * (2 if bf16 else 4)
            / H100_SXM.hbm_bandwidth * 1e3}


def matmul_bf16(mat2, labels, inv_gs, ms, library_ms) -> dict:
    """The matmul kernel on bf16 mat2 (the reference's bf16 mode) at the
    main path's shape: held to the plain one-hot form on the same
    bf16-rounded operands and sqrt(w) at SW_MAIN_RTOL, timed beside the f32
    kernel and the library call; both dtypes' one-hot floors and rates.
    Returns the fields the matmul row adds."""
    import torch
    from repro_torch.core import fstat
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.permanova_sw import ops
    m16 = mat2.to(torch.bfloat16)
    got = ops.permanova_sw(m16, labels, inv_gs, variant="matmul")
    # sqrt of a squared bf16 value is that value, so the plain form's
    # factor carries exactly the bf16-rounded sqrt(w) the kernel uses
    w16 = ops._rounded_sqrt_w(inv_gs, torch.bfloat16) ** 2
    want = fstat.sw_matmul(m16.float(), labels, w16)
    err16 = rel_err(got, want)
    check(err16 <= SW_MAIN_RTOL,
          f"bf16 matmul kernel != plain on bf16 operands at the main-path "
          f"shape: rel {err16:.3e} (limit {SW_MAIN_RTOL})")
    del got, want
    ms16 = cuda_ms(lambda: ops.permanova_sw(m16, labels, inv_gs,
                                            variant="matmul"), reps=3)
    b16, by16 = bound_ms(m16, labels, inv_gs, H100_SXM)
    del m16
    f32, bf = (onehot_floors(labels, inv_gs, bf16) for bf16 in (False,
                                                                 True))
    flop = f32["onehot_flop"]
    shape = f"(n={EMP_N}, P={labels.shape[0]}, G={EMP_GROUPS})"
    for tag, t, fl in (("f32 ", ms, f32), ("bf16", ms16, bf)):
        log(f"[smoke] timing matmul    {shape} {tag}: kernel {t:.3f} ms, "
            f"library (one-hot torch.matmul, f32) {library_ms:.3f} ms, "
            f"kernel/library {t / library_ms:.3f}; one-hot form {flop:.4g} "
            f"FLOP x {fl['onehot_products']} tensor-core product(s) = "
            f"{fl['onehot_products'] * flop / t / 1e9:.2f} TFLOP/s issued "
            f"({flop / t / 1e9:.2f} of the one-hot form); one-hot floors: "
            f"operations {fl['onehot_ops_floor_ms']:.3f} ms, bytes of "
            f"{fl['onehot_passes']} mat2 passes "
            f"{fl['onehot_bytes_floor_ms']:.3f} ms")
    log(f"[smoke] timing matmul    {shape} bf16 {ms16:.3f} ms vs f32 "
        f"{ms:.3f} ms: bf16/f32 {ms16 / ms:.3f}; bf16 max_rel_err "
        f"{err16:.3e} vs plain on bf16 operands; the function's bound "
        f"{b16:.3f} ms ({by16}) on bf16 mat2")
    return {"ms_bf16": ms16, "max_rel_err_bf16": err16,
            "bound_ms_bf16": b16, "bound_by_bf16": by16}


def draw_checks(dev, g_dev, chunk):
    """The label draws of a chunk of the dense and stream bridges (chunk =
    the planner's at the default label budget): their device memory above
    the start, less the labels themselves, within that budget when drawn
    in the budget's sub-blocks (core.permutations.draw_rows), and their
    time, each beside the whole chunk drawn in one piece; then the design
    path's index draw (free and within 4 strata) at its chunk."""
    import torch
    from repro_torch.core import permutations
    from repro_torch.engine import planner
    budget = planner.DEFAULT_STREAM_BUDGET_BYTES
    strata = (torch.arange(EMP_N, device=dev) % DESIGN_STRATA).to(
        torch.int32)
    draws = {
        "permutation_batch": ("labels", lambda r: (
            permutations.permutation_batch(
                g_dev, chunk, 2 * chunk, seed=0, block_rows=r))),
        "strata_label_batch": ("strata", lambda r: (
            permutations.strata_label_batch(
                g_dev, strata, chunk, 2 * chunk, seed=0, block_rows=r)))}
    for name, (kind, draw) in draws.items():
        rows = permutations.draw_rows(EMP_N, budget, kind)
        out = {}
        for r in (rows, chunk):
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            lab = draw(r)
            torch.cuda.synchronize()
            transient = (torch.cuda.max_memory_allocated() - start
                         - lab.numel() * lab.element_size())
            out[r] = (lab, transient, cuda_ms(lambda: draw(r), reps=3))
            del lab
        (sub, t_sub, ms_sub), (whole, t_whole, ms_whole) = out[rows], \
            out[chunk]
        check(torch.equal(sub, whole),
              f"{name}: sub-blocks of {rows} rows != the whole chunk")
        check(t_sub <= budget,
              f"{name}: draw transients {t_sub / 2**20:.1f} MiB > the "
              f"{budget / 2**20:.0f} MiB label budget")
        n_sub = -(-chunk // rows)
        log(f"[smoke] draw {name} (n={EMP_N}, chunk={chunk}): {n_sub} "
            f"sub-blocks of {rows} rows: transients {t_sub / 2**20:.1f} MiB "
            f"(model {permutations.draw_transient_bytes(rows, EMP_N, kind) / 2**20:.1f}"
            f" MiB, budget {budget / 2**20:.0f}), {ms_sub:.3f} ms; the whole "
            f"chunk at once {t_whole / 2**20:.1f} MiB, {ms_whole:.3f} ms; "
            f"bit-identical labels")
        del sub, whole
    draw_model_checks(g_dev, strata)
    rows = permutations.draw_rows(EMP_N, budget, "index")
    free = torch.zeros(EMP_N, dtype=torch.int32, device=dev)
    for name, st in (("free", free), ("4 strata", strata)):
        ms = cuda_ms(lambda: permutations.strata_permutation_batch(
            st, 0, cols_plan()[0], seed=0, block_rows=rows), reps=5)
        log(f"[smoke] draw index permutations {name} (n={EMP_N}, "
            f"chunk={cols_plan()[0]}, one sub-block of "
            f"{min(rows, cols_plan()[0])} rows): {ms:.3f} ms")


def draw_model_checks(g_dev, strata):
    """Each kind of draw (free labels, labels within 4 strata, index
    permutations within them) as one sub-block of DRAW_MODEL_ROWS rows at
    the EMP shape: its transients above the start, less its output, held
    under core.permutations' model for that kind, and its time (the
    fused-kernel plan's DRAW_SUB_BLOCK_MS weighs a sub-block by it)."""
    import torch
    from repro_torch.core import permutations
    draws = {
        "labels": lambda r: permutations.permutation_batch(
            g_dev, 7, 7 + r, seed=0, block_rows=r),
        "strata": lambda r: permutations.strata_label_batch(
            g_dev, strata, 7, 7 + r, seed=0, block_rows=r),
        "index": lambda r: permutations.strata_permutation_batch(
            strata, 7, 7 + r, seed=0, block_rows=r)}
    for kind, draw in draws.items():
        notes = []
        for r in DRAW_MODEL_ROWS:
            draw(r)
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = draw(r)
            torch.cuda.synchronize()
            transient = (torch.cuda.max_memory_allocated() - start
                         - out.numel() * out.element_size())
            model = permutations.draw_transient_bytes(r, EMP_N, kind)
            check(transient <= model,
                  f"draw {kind} at {r} rows: transients {transient} B > "
                  f"the model's {model} B")
            del out
            ms = cuda_ms(lambda: draw(r), reps=5)
            notes.append(f"{r} rows {transient / (r * EMP_N):.2f} B/elt "
                         f"{ms:.3f} ms")
        log(f"[smoke] draw model {kind} (n={EMP_N}, one sub-block; model "
            f"{permutations.DRAW_BYTES_PER_ELEMENT[kind]} B/elt): "
            f"{'; '.join(notes)}")


def phase_reference(dev):
    """engine.run on the card against engine.run on the CPU (the plain
    forms) on a small study: the same seed gives the same labels."""
    import torch
    from repro_torch import engine
    from repro_torch.core.distance import distance_matrix
    from repro_torch.data.microbiome import synthetic_study
    x, grouping = synthetic_study(300, 64, 4, effect_size=0.3, seed=5)
    dm = distance_matrix(torch.from_numpy(x), "braycurtis")
    for impl in ("brute", "tiled", "matmul"):
        kw = dict(n_perms=199, impl=impl, seed=3, chunk=64)
        on_card = engine.run(dm.to(dev), torch.from_numpy(grouping),
                             device=dev, **kw)
        on_cpu = engine.run(dm, torch.from_numpy(grouping), device="cpu",
                            **kw)
        f_c, f_h = float(on_card.f_stat), float(on_cpu.f_stat)
        p_c, p_h = float(on_card.p_value), float(on_cpu.p_value)
        check(abs(f_c - f_h) <= RTOL * abs(f_h) and p_c == p_h,
              f"{impl}: card F={f_c} p={p_c} vs CPU F={f_h} p={p_h}")
        log(f"[smoke] reference n=300 {impl:6s} card F={f_c:.7g} p={p_c} | "
            f"CPU F={f_h:.7g} p={p_h}")


def dist_operands(xr, xc):
    """Each distance kernel's operands for rows xr against rows xc."""
    from repro_torch.core.distance import (pack_presence_bits,
                                           presence_prepare)
    pr, pc = presence_prepare(xr), presence_prepare(xc)
    return {"braycurtis": (xr, xc), "euclidean": (xr, xc),
            "jaccard": (pr, pc),
            "jaccard_packed": (pack_presence_bits(pr),
                               pack_presence_bits(pc))}


def self_pairs_zeroed(d, lo=0):
    """d with its (global row == col) entries zeroed, rows starting at
    global row lo: the contract both bridges apply (pairwise_distance
    zeroes the diagonal, the stream step masks it while squaring)."""
    d = d.clone()
    d.diagonal(offset=lo).zero_()
    return d


def phase_distance_kernels(dev, x_np):
    """Every distance kernel against its plain version at
    DIST_CHECK_SHAPES; the (256, n, 128) slab is the EMP table's first 256
    rows against the whole table, as the stream bridge's first slab. Then
    the whole-table calls (symmetric visit) against the rectangular call
    on a clone of the table, bit for bit off the diagonal, at
    DIST_SYM_SHAPES and the EMP table for every kernel; then euclidean
    against float64 (euclidean_f64_check) at (2047, 128) and the EMP
    table."""
    import numpy as np
    import torch
    from repro_torch.data.microbiome import synthetic_abundance
    from repro_torch.kernels.distance import ops as dops, ref as dref
    worst = {k: 0.0 for k in dops.KERNELS}
    for nr, nc, d in DIST_CHECK_SHAPES:
        x = torch.from_numpy(synthetic_abundance(nc, d, seed=nr + nc + d)
                             ).to(dev)
        outs = {}
        for k, (a, b) in dist_operands(x[:nr].contiguous(), x).items():
            got = self_pairs_zeroed(dops.pairwise_rect(a, b, kernel=k))
            want = self_pairs_zeroed(dref.REFS[k](a, b))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst[k] = max(worst[k], err)
            check(got.shape == (nr, nc) and bool(torch.isfinite(got).all())
                  and torch.allclose(got, want, rtol=RTOL, atol=ATOL),
                  f"{k} kernel != plain at {(nr, nc, d)}: abs {err:.3e}")
            log(f"[smoke] kernel {k:14s} (nr,nc,d)={(nr, nc, d)} "
                f"max_abs_err={err:.3e} vs plain")
            outs[k] = got
        check(torch.equal(outs["jaccard_packed"], outs["jaccard"]),
              f"jaccard_packed != jaccard kernel bit for bit at "
              f"{(nr, nc, d)}")
        log(f"[smoke] kernel jaccard_packed == jaccard bit for bit at "
            f"{(nr, nc, d)} ({np.prod((nr, nc))} entries)")
    sym_tables = [(n, d, torch.from_numpy(synthetic_abundance(
        n, d, seed=2 * n + d)).to(dev), dops.KERNELS)
        for n, d in DIST_SYM_SHAPES]
    sym_tables.append((EMP_N, EMP_FEATURES, torch.from_numpy(x_np).to(dev),
                       dops.KERNELS))
    for n, d, x, kernels in sym_tables:
        ops_ = dist_operands(x, x)
        outs = {}
        for k in kernels:
            a = ops_[k][0]
            check(dops.is_symmetric_call(a, a)
                  and not dops.is_symmetric_call(a, a.clone()),
                  "the symmetric predicate must hold for one table only")
            got = dops.pairwise_rect(a, a, kernel=k)
            rect = dops.pairwise_rect(a, a.clone(), kernel=k)
            torch.cuda.synchronize()
            off = ~torch.eye(n, dtype=torch.bool, device=dev)
            check(torch.equal(got[off], rect[off]),
                  f"{k}: the symmetric call != the rectangular call bit for "
                  f"bit off the diagonal at {(n, d)}")
            del rect
            want = dref.REFS[k](a, a)
            err = float((got[off] - want[off]).abs().max())
            worst[k] = max(worst[k], err)
            check(bool(torch.isfinite(got).all()) and torch.allclose(
                got[off], want[off], rtol=RTOL, atol=ATOL),
                f"{k} symmetric call != plain at {(n, d)}: abs {err:.3e}")
            log(f"[smoke] kernel {k:14s} (n,d)={(n, d)} symmetric call == "
                f"rectangular call (a clone) bit for bit off the diagonal; "
                f"max_abs_err={err:.3e} vs plain")
            outs[k] = got
            del want, off
        check(torch.equal(outs["jaccard_packed"], outs["jaccard"]),
              f"jaccard_packed != jaccard symmetric call at {(n, d)}")
        del outs, ops_
    for n, d, x in ((2047, 128, torch.from_numpy(synthetic_abundance(
            2047, 128, seed=3)).to(dev)),
                    (EMP_N, EMP_FEATURES, torch.from_numpy(x_np).to(dev))):
        euclidean_f64_check(x)
    return worst


def euclidean_f64_check(x):
    """The euclidean kernel's whole-table call (three TF32 products)
    against a float64 oracle of the Gram form: within twice the plain f32
    version's error of it; the plain version with its matmul in TF32 (a
    one-product stand-in) must miss that bar. Diagonals are zero, as
    pairwise_distance makes them; the oracle runs in row blocks."""
    import torch
    from repro_torch.kernels.distance import ops as dops, ref as dref
    n = x.shape[0]
    got = dops.pairwise_rect(x, x, kernel="euclidean").fill_diagonal_(0.0)
    plain = dref.euclidean_ref(x, x).fill_diagonal_(0.0)
    with tf32_matmuls():
        tf32 = dref.euclidean_ref(x, x).fill_diagonal_(0.0)
        torch.cuda.synchronize()
    x64 = x.double()
    sq = (x64 * x64).sum(1)
    errs = [0.0, 0.0, 0.0]
    for lo in range(0, n, 4096):
        hi = min(n, lo + 4096)
        o64 = torch.sqrt((sq[lo:hi, None] + sq[None, :]
                          - 2.0 * (x64[lo:hi] @ x64.T)).clamp(min=0.0))
        o64[:, lo:hi].fill_diagonal_(0.0)
        for e, out in enumerate((got, plain, tf32)):
            errs[e] = max(errs[e],
                          float((out[lo:hi].double() - o64).abs().max()))
        del o64
    e_kernel, e_plain, e_tf32 = errs
    log(f"[smoke] kernel euclidean         (n,d)={(n, x.shape[1])} against "
        f"float64 (Gram form): kernel {e_kernel:.3e}, plain f32 "
        f"{e_plain:.3e} ({e_kernel / e_plain:.2f}x; bar 2x), TF32 "
        f"torch.matmul stand-in {e_tf32:.3e} ({e_tf32 / e_plain:.1f}x)")
    check(e_kernel <= 2.0 * e_plain,
          f"euclidean kernel {e_kernel:.3e} from float64, over twice the "
          f"plain f32 version's {e_plain:.3e} at n={n}")
    check(e_tf32 > 2.0 * e_plain,
          f"the TF32 stand-in ({e_tf32:.3e}) passes the float64 bar at "
          f"n={n}: the bar would not reject one TF32 product")


def phase_pipeline(dev, x_np, grouping, f_p_main):
    """pipeline() from the EMP features: the dense and the stream bridge,
    picked by the planner from the matrix budget, with each run's own
    launch counts; then each other distance kernel's own dense path.
    Returns the launch counts by path and the dense bridge's (F, p, null
    F) for phase 9."""
    import torch
    from repro_torch import pipeline
    from repro_torch.pipeline import registry, streaming
    x = torch.from_numpy(x_np).to(dev)
    g_dev = torch.from_numpy(grouping).to(dev)
    f0, p0 = f_p_main
    n_slabs = -(-EMP_N // STREAM_ROWS)
    paths, results = {}, {}
    for bridge, budget in BRIDGE_BUDGETS.items():
        zero_launches()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = pipeline.pipeline(x, g_dev, metric="braycurtis",
                                n_perms=EMP_PERMS, seed=0,
                                matrix_budget_bytes=budget, device=dev)
        f_b, p_b = float(res.f_stat), float(res.p_value)      # waits
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - start
        paths[bridge] = launch_counts()
        results[bridge] = (f_b, p_b)
        if bridge == "dense":
            dense = (f_b, p_b, res.f_perms)
        log(f"[smoke] pipeline {bridge:6s} n={EMP_N} perms={EMP_PERMS} "
            f"{dt:.3f}s end to end F={f_b:.7g} p={p_b:.6g} "
            f"launches={paths[bridge]} peak device memory above the "
            f"call's start {peak / 2**20:.1f} MiB")
        log(f"[smoke] pipeline {bridge:6s} plan: {res.plan}")
        check(res.plan.startswith(
            f"braycurtis.cuda[] -> {bridge}(rows={STREAM_ROWS})"),
            f"expected braycurtis.cuda -> {bridge}, got {res.plan!r}")
        check(res.method == f"pipeline[braycurtis.cuda->{bridge}->brute]",
              f"unexpected method {res.method!r}")
        want = {k: 0 for k in paths[bridge]}
        want.update(brute=2,
                    braycurtis=1 if bridge == "dense" else n_slabs)
        check(paths[bridge] == want,
              f"{bridge} bridge launches {paths[bridge]} != {want}")
        check(res.f_perms.device == dev
              and res.f_perms.shape == (EMP_PERMS + 1,)
              and bool(torch.isfinite(res.f_perms).all()),
              "null distribution must be finite, (n_perms + 1,), on the card")
        for name, (f, p) in (("phase 3 engine.run", (f0, p0)),
                             ("the dense bridge", results["dense"])):
            check(abs(f_b - f) <= RTOL * abs(f) and p_b == p,
                  f"{bridge} bridge F={f_b} p={p_b} vs {name} F={f} p={p}")
        # stage 1 alone, timed outside the counted run
        prepare, rows_fn, dense_fn = registry.get("braycurtis.cuda").bound()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if bridge == "dense":
            out = dense_fn(x)
            torch.cuda.synchronize()
        else:
            out, _ = streaming.build_mat2_streaming(
                prepare(x), rows_fn, block=STREAM_ROWS)   # ends in a sync
        t_stage1 = time.perf_counter() - t0
        del out
        what = "D" if bridge == "dense" else \
            f"mat2 + Gower row sums, {n_slabs} slabs"
        log(f"[smoke] pipeline {bridge:6s} stage 1 alone {t_stage1:.4f}s "
            f"({what})")
        del res

    others = {}
    for metric, tuning, kernel in OTHER_PATHS:
        zero_launches()
        t0 = time.perf_counter()
        res = pipeline.pipeline(x, g_dev, metric=metric,
                                n_perms=CROSS_PERMS, seed=0,
                                dist_tuning=tuning,
                                matrix_budget_bytes=BRIDGE_BUDGETS["dense"],
                                device=dev)
        f_m, p_m = float(res.f_stat), float(res.p_value)
        dt = time.perf_counter() - t0
        tag = kernel if metric != "aitchison" else "aitchison"
        paths[tag] = launch_counts()
        others[tag] = (res.f_stat, p_m)
        log(f"[smoke] pipeline dense {tag:14s} perms={CROSS_PERMS} "
            f"{dt:.3f}s F={f_m:.7g} p={p_m:.6g} launches={paths[tag]} "
            f"plan: {res.plan.split(' | ')[0]}")
        want = {k: 0 for k in paths[tag]}
        want.update(brute=1, **{kernel: 1})
        check(paths[tag] == want,
              f"{tag} path launches {paths[tag]} != {want}")
        check(res.f_perms.device == dev
              and bool(torch.isfinite(res.f_perms).all())
              and f_m > 0.0 and 0.0 < p_m <= 1.0,
              f"{tag} path: F/p out of range")
        del res
    check(torch.equal(others["jaccard_packed"][0], others["jaccard"][0])
          and others["jaccard_packed"][1] == others["jaccard"][1],
          "packed jaccard F/p != float jaccard F/p bit for bit")
    log("[smoke] pipeline jaccard packed=1 F == packed=0 F bit for bit")
    return paths, dense


def dist_pairs(a, b) -> float:
    """Pairs a call computes: each pair once for a whole-table call (the
    kernel's symmetric visit), every (row, column) for a slab."""
    from repro_torch.kernels.distance import ops as dops
    n = a.shape[0]
    return n * (n - 1) / 2 if dops.is_symmetric_call(a, b) \
        else float(a.shape[0] * b.shape[0])


def dist_tc_ms(kernel, a, b) -> float:
    """The product of a tensor-core distance kernel in its exact form
    (DIST_TC_PRODUCT: 2 operations per (pair, feature) a product) at the
    dense peak of its type, over the pairs the call computes."""
    products, kind = DIST_TC_PRODUCT[kernel]
    return products * 2 * dist_pairs(a, b) * a.shape[1] / TC_PEAK[kind] \
        * 1e3


def dist_bound_ms(kernel, a, b, chip) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time this card could take
    for the distances of a's rows against b's rows — inputs read once and
    the f32 output written once at the HBM rate, against the operations:
    for braycurtis the feature loop at the f32 CUDA-core peak, 2 per
    (pair, feature) (a subtract and an add of its magnitude); 3 per (pair,
    word) for jaccard_packed (AND, popcount, add; the guide's table has no
    int32 row, and the f32 rate bounds it from below); for euclidean and
    jaccard their products on the tensor cores in the exact form
    (dist_tc_ms: three TF32 products, one int8 product). Each pair once
    for a whole-table call. The O(n^2) finalize and O(n d) row sums are
    left out, so this stays a lower bound."""
    nr, nc, w = a.shape[0], b.shape[0], a.shape[1]
    nbytes = (a.numel() + b.numel()) * a.element_size() + 4 * nr * nc
    t_bytes = nbytes / chip.hbm_bandwidth * 1e3
    if kernel in DIST_TC_PRODUCT:
        t_ops = dist_tc_ms(kernel, a, b)
    else:
        ops_ = (3 if kernel == "jaccard_packed" else 2) * dist_pairs(a, b) * w
        t_ops = ops_ / chip.peak_flops_f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dist_own_floor_ms(kernel, a, b) -> float:
    """A distance kernel's own floor (its formulation's, not the
    function's bound), over the pairs the call computes: for euclidean
    and jaccard the tensor-core product at the dense peak (dist_tc_ms);
    for braycurtis DIST_OWN_INSTR instructions per (pair, feature) on the
    FP32 lanes and for jaccard_packed the popcount per (pair, word), at
    the boost clock."""
    if kernel in DIST_TC_PRODUCT:
        return dist_tc_ms(kernel, a, b)
    per_sm = POPC_PER_SM if kernel == "jaccard_packed" \
        else FP32_LANES_PER_SM
    instr = DIST_OWN_INSTR[kernel] * dist_pairs(a, b) * a.shape[1]
    return instr / (per_sm * SMS * BOOST_HZ) * 1e3


def phase_distance_timings(dev, x_np, paths, worst):
    """Each distance kernel at the main path's shapes: (n, n, 128) once
    (dense bridge; the whole-table call, each pair once, and for scale
    the rectangular call on a clone), the (256, n, 128) slab 99 times
    (stream bridge); each beside its bound and its own floor (a time under
    the floor fails the run), and for scale beside jaccard the
    intersection alone as one bf16 torch.matmul."""
    import torch
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.distance import ops as dops, ref as dref
    x = torch.from_numpy(x_np).to(dev)
    dense_ops = dist_operands(x, x)
    slab_ops = dist_operands(x[:STREAM_ROWS].contiguous(), x)
    n_slabs = -(-EMP_N // STREAM_ROWS)
    own_path = {"braycurtis": "dense", "euclidean": "euclidean",
                "jaccard": "jaccard", "jaccard_packed": "jaccard_packed"}
    rows, outs = [], {}
    for k in dops.KERNELS:
        a = dense_ops[k][0]         # one table: the dense bridge's call
        sa, sb = slab_ops[k]
        got = dops.pairwise_rect(a, a, kernel=k).fill_diagonal_(0.0)
        want = dref.REFS[k](a, a).fill_diagonal_(0.0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{k} kernel != plain at the main-path shape: abs {err:.3e}")
        if k.startswith("jaccard"):
            outs[k] = got
        del got, want
        ms = cuda_ms(lambda: dops.pairwise_rect(a, a, kernel=k), reps=3)
        a2 = a.clone()
        rect_ms = cuda_ms(lambda: dops.pairwise_rect(a, a2, kernel=k),
                          reps=3)
        del a2
        plain_ms = cuda_ms(lambda: dref.REFS[k](a, a), reps=1,
                           warm=lambda: dref.REFS[k](sa, sb))
        slab_ms = cuda_ms(lambda: dops.pairwise_rect(sa, sb, kernel=k),
                          reps=10)
        slab_plain_ms = cuda_ms(lambda: dref.REFS[k](sa, sb), reps=3)
        library_ms = None
        if k == "euclidean":
            library_ms = cuda_ms(lambda: torch.cdist(a, a), reps=3)
            check(ms <= library_ms,
                  f"euclidean kernel {ms:.3f} ms slower than torch.cdist "
                  f"{library_ms:.3f} ms")
        inter_ms = None
        if k == "jaccard":   # for scale: the intersection alone
            a16 = a.to(torch.bfloat16)
            inter_ms = cuda_ms(lambda: a16 @ a16.T, reps=3)
            del a16
        b_ms, b_by = dist_bound_ms(k, a, a, H100_SXM)
        sb_ms, sb_by = dist_bound_ms(k, sa, sb, H100_SXM)
        floor_ms = dist_own_floor_ms(k, a, a)
        slab_floor_ms = dist_own_floor_ms(k, sa, sb)
        check(ms > max(floor_ms, b_ms) and slab_ms > max(slab_floor_ms,
                                                         sb_ms),
              f"{k} reads under its floors: dense {ms:.3f} ms (floors "
              f"{floor_ms:.3f}, {b_ms:.3f}), slab {slab_ms:.4f} ms "
              f"({slab_floor_ms:.4f}, {sb_ms:.4f}): a count is wrong")
        rows.append({
            "name": f"distance.{k}", "route": "cuda",
            "source": DIST_SOURCE, "replaces": DIST_REPLACES[k],
            "path": f"pipeline {own_path[k]}",
            "launches": paths[own_path[k]][k],
            "launches_by_path": {p: c[k] for p, c in paths.items()},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "rect_ms": rect_ms, "intersection_bf16_matmul_ms": inter_ms,
            "shape": {"nr": EMP_N, "nc": EMP_N, "d": EMP_FEATURES,
                      "operand_cols": a.shape[1], "symmetric": True},
            "max_abs_err_checks": worst[k],
            "stream_slab": {"nr": STREAM_ROWS, "nc": EMP_N, "ms": slab_ms,
                            "plain_ms": slab_plain_ms, "bound_ms": sb_ms,
                            "bound_by": sb_by, "slabs": n_slabs,
                            "launches": paths["stream"][k]},
        })
        log(f"[smoke] timing {k:14s} (n={EMP_N}, d={EMP_FEATURES}) dense "
            f"(whole table, each pair once): kernel {ms:.3f} ms (the "
            f"rectangular call on a clone {rect_ms:.3f} ms), plain "
            f"{plain_ms:.3f} ms, library {library_ms} ms, the intersection "
            f"alone as a bf16 torch.matmul {inter_ms} ms, bound {b_ms:.3f} "
            f"ms ({b_by}), own floor {floor_ms:.3f} ms "
            f"({floor_ms / ms * 100:.1f}% of the kernel's time); slab "
            f"({STREAM_ROWS}, n): kernel {slab_ms:.4f} ms x {n_slabs} = "
            f"{slab_ms * n_slabs:.3f} ms, plain {slab_plain_ms:.3f} ms, "
            f"bound {sb_ms:.4f} ms ({sb_by}), own floor "
            f"{slab_floor_ms:.4f} ms; max_abs_err {err:.3e}")
    check(torch.equal(outs["jaccard_packed"], outs["jaccard"]),
          "jaccard_packed != jaccard kernel bit for bit at the main shape")
    return rows


def fused_instance(n, d, p, g, seed, device):
    """Abundance-like features, labels (P, n) with every group present,
    and inv_gs, for the fused kernel's checks."""
    import numpy as np
    import torch
    from repro_torch.core import permutations
    from repro_torch.data.microbiome import synthetic_abundance
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(synthetic_abundance(n, d, seed=seed)).to(device)
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    gperms = np.stack([rng.permutation(grouping) for _ in range(p)])
    labels = torch.from_numpy(gperms.astype(np.int32)).to(device)
    inv_gs = permutations.inv_group_sizes(
        torch.from_numpy(grouping).to(device), g)
    return x, labels, inv_gs


def emp_chunk(dev, x_np, grouping):
    """The main path's first fused chunk: the EMP features on the card,
    the first fused_plan() chunk of permutation slots of seed 0 and
    inv_gs."""
    import torch
    from repro_torch.core import permutations
    x = torch.from_numpy(x_np).to(dev)
    g = torch.from_numpy(grouping).to(dev)
    labels = permutations.permutation_batch(g, 0, fused_plan()[0], seed=0)
    return x, labels, permutations.inv_group_sizes(g, EMP_GROUPS)


def fused_padded_checks(xp, labels, inv_gs, metric, sw, rs) -> str:
    """The labels kernel on the table zero-padded to PAD_ROWS rows (pad
    labels 0) with n_valid = n: its SLAB_ROWS-row offset slabs, the last
    all pad rows and so exact zeros, and the whole padded table in one
    call (the symmetric visit, its columns past n_valid masked) give the
    unpadded call (sw, rs) at SLAB_RTOL and the plain version on the
    padded table at FUSED_RTOL. Returns a note for the log."""
    import torch
    from repro_torch.kernels.fused_sw import ops as fops, ref as fref
    n = xp.shape[0]
    pad = PAD_ROWS - n
    xq = torch.nn.functional.pad(xp, (0, 0, 0, pad)).contiguous()
    gq = torch.nn.functional.pad(labels, (0, pad)).contiguous()
    parts = [fops.fused_sw_rows(
        xq[lo:lo + SLAB_ROWS].contiguous(), xq,
        gq[:, lo:lo + SLAB_ROWS].contiguous(), gq, inv_gs, lo,
        metric=metric, n_valid=n) for lo in range(0, PAD_ROWS, SLAB_ROWS)]
    sw_s = torch.stack([q[0] for q in parts]).sum(dim=0)
    rs_s = torch.cat([q[1] for q in parts])
    check(fops.is_symmetric_call(xq, xq, gq, gq, 0),
          "the padded whole-table call must take the symmetric visit")
    sw_q, rs_q = fops.fused_sw_rows(xq, xq, gq, gq, inv_gs, 0,
                                    metric=metric, n_valid=n)
    sw_p, rs_p = fref.fused_sw_ref(xq, xq, gq, gq, inv_gs, 0,
                                   metric=metric, n_valid=n)
    torch.cuda.synchronize()
    for what, s_w, r_s in (("offset slabs", sw_s, rs_s),
                           ("one call", sw_q, rs_q)):
        check(torch.allclose(s_w, sw, rtol=SLAB_RTOL, atol=ATOL)
              and torch.allclose(r_s[:n], rs, rtol=SLAB_RTOL, atol=0)
              and bool((r_s[n:] == 0).all())
              and torch.allclose(s_w, sw_p, rtol=FUSED_RTOL, atol=ATOL)
              and torch.allclose(r_s, rs_p, rtol=FUSED_RTOL, atol=ATOL),
              f"fused {metric}: the {PAD_ROWS}-row padded table (n_valid "
              f"{n}), {what}, != the unpadded call or the plain version: "
              f"rel {rel_err(s_w, sw):.3e} / {rel_err(s_w, sw_p):.3e}")
    check(bool((parts[-1][0] == 0).all()),
          f"fused {metric}: the all-pad slab gave a nonzero s_W")
    return (f"the {PAD_ROWS}-row padded table's {len(parts)} slabs (the "
            f"last all pad, zeros) and one call equal it (rel "
            f"{rel_err(sw_s, sw):.3e} / {rel_err(sw_q, sw):.3e}; plain "
            f"{rel_err(sw_q, sw_p):.3e})")


def phase_fused_kernel(dev, x_np, grouping):
    """The fused kernel against its plain version at FUSED_CHECK_SHAPES
    and FUSED_SYM_SHAPES (whole-table calls, the symmetric visit), offset
    slabs and permutation splits at FUSED_SPLIT_SHAPE, and at the EMP
    shape at P = ONEHOT_CHUNK and the plan's chunk. Returns its largest
    errors for the kernels line."""
    import torch
    from repro_torch.core.distance import ROW_METRICS
    from repro_torch.kernels.fused_sw import ops as fops, ref as fref
    worst_rel = 0.0
    for n, d, p, g in (FUSED_CHECK_SHAPES + FUSED_SYM_SHAPES
                       + [FUSED_SPLIT_SHAPE]):
        x, labels, inv_gs = fused_instance(n, d, p, g, n + d + p, dev)
        for metric in fops.FUSED_METRICS:
            xp = ROW_METRICS[metric].prepare(x).contiguous()

            def call(lo, hi, lab_lo=0, lab_hi=p):
                lab = labels[lab_lo:lab_hi].contiguous()
                return fops.fused_sw_rows(xp[lo:hi].contiguous(), xp,
                                          lab[:, lo:hi].contiguous(), lab,
                                          inv_gs, lo, metric=metric)
            check(fops.is_symmetric_call(
                xp[0:n].contiguous(), xp, labels[:, 0:n].contiguous(),
                labels, 0), "a whole-table call must take the symmetric "
                "visit")
            sw, rs = call(0, n)
            sw_p, rs_p = fref.fused_sw_ref(xp, xp, labels, labels, inv_gs,
                                           0, metric=metric)
            torch.cuda.synchronize()
            err = rel_err(sw, sw_p)
            worst_rel = max(worst_rel, err)
            check(sw.shape == (p,) and rs.shape == (n,)
                  and bool(torch.isfinite(sw).all())
                  and torch.allclose(sw, sw_p, rtol=FUSED_RTOL, atol=ATOL)
                  and torch.allclose(rs, rs_p, rtol=FUSED_RTOL, atol=ATOL),
                  f"fused {metric} kernel != plain at {(n, d, p, g)}: s_W "
                  f"rel {err:.3e}, row sums abs "
                  f"{float((rs - rs_p).abs().max()):.3e}")
            log(f"[smoke] kernel fused_sw {metric:10s} (n,d,P,G)="
                f"{(n, d, p, g)} symmetric visit: s_W max_rel_err="
                f"{err:.3e} row sums max_rel_err={rel_err(rs, rs_p):.3e} "
                f"vs plain")
            if (n, d, p, g) != FUSED_SPLIT_SHAPE:
                continue
            parts = [call(lo, min(lo + SLAB_ROWS, n))
                     for lo in range(0, n, SLAB_ROWS)]
            sw_s = torch.stack([q[0] for q in parts]).sum(dim=0)
            rs_s = torch.cat([q[1] for q in parts])
            check(torch.allclose(sw_s, sw, rtol=SLAB_RTOL, atol=0)
                  and torch.allclose(rs_s, rs, rtol=SLAB_RTOL, atol=0),
                  f"fused {metric}: {len(parts)} offset slabs of "
                  f"{SLAB_ROWS} rows != the full call")
            pad_note = fused_padded_checks(xp, labels, inv_gs, metric, sw,
                                           rs)
            splits = []
            for split in SPLITS:
                bounds = [0, split[0], split[0] + split[1], sum(split)]
                sw_c = torch.cat([call(0, n, a, b)[0]
                                  for a, b in zip(bounds, bounds[1:])])
                want = sw[:sum(split)]
                check(torch.allclose(sw_c, want, rtol=SPLIT_RTOL, atol=0),
                      f"fused {metric}: chunks {split} != one call of "
                      f"{p}: rel {rel_err(sw_c, want):.3e}")
                splits.append(f"chunks {split} equal one call (rel "
                              f"{rel_err(sw_c, want):.3e})")
            log(f"[smoke] kernel fused_sw {metric:10s} n={n}: "
                f"{len(parts)} offset slabs sum to the full call (rel "
                f"{rel_err(sw_s, sw):.3e}), {pad_note}, "
                f"{', '.join(splits)}")
    x, labels, inv_gs = emp_chunk(dev, x_np, grouping)
    out = {"max_rel_err_checks": worst_rel}
    for p in (ONEHOT_CHUNK, labels.shape[0]):
        lab = labels[:p].contiguous()
        sw, rs = fops.fused_sw_rows(x, x, lab, lab, inv_gs, 0)
        sw_p, rs_p = fref.fused_sw_ref(x, x, lab, lab, inv_gs, 0)
        torch.cuda.synchronize()
        err, err_abs = rel_err(sw, sw_p), float((sw - sw_p).abs().max())
        check(bool(torch.isfinite(sw).all()) and err <= SW_MAIN_RTOL
              and torch.allclose(rs, rs_p, rtol=FUSED_RTOL, atol=ATOL),
              f"fused kernel != plain at the EMP shape, P = {p}: s_W rel "
              f"{err:.3e} (limit {SW_MAIN_RTOL})")
        log(f"[smoke] kernel fused_sw braycurtis (n,d,P,G)="
            f"{(EMP_N, EMP_FEATURES, p, EMP_GROUPS)} s_W "
            f"max_rel_err={err:.3e} (limit {SW_MAIN_RTOL}) max_abs_err="
            f"{err_abs:.3e}; row sums max_rel_err={rel_err(rs, rs_p):.3e}")
        out.update(max_abs_err=err_abs, max_rel_err=err)   # the plan's
    return out


def phase_fused_pipeline(dev, x_np, grouping, f_p_main, dense):
    """pipeline() at the EMP shape with the default budgets (the
    fused-kernel bridge), then the fused bridge at 999 permutations, each
    with its own launch counts. Returns the launch counts by path."""
    import torch
    from repro_torch import pipeline
    from repro_torch.core.permanova import p_value_from_null
    x = torch.from_numpy(x_np).to(dev)
    g_dev = torch.from_numpy(grouping).to(dev)
    f0, p0 = f_p_main
    f_d, p_d, null_d = dense
    paths = {}

    zero_launches()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pipeline.pipeline(x, g_dev, metric="braycurtis",
                            n_perms=EMP_PERMS, seed=0, device=dev)
    f_k, p_k = float(res.f_stat), float(res.p_value)          # waits
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    paths["fused-kernel"] = launch_counts()
    log(f"[smoke] pipeline fused-kernel n={EMP_N} perms={EMP_PERMS} default "
        f"budgets {dt:.3f}s end to end F={f_k:.7g} p={p_k:.6g} "
        f"launches={paths['fused-kernel']}")
    log(f"[smoke] pipeline fused-kernel plan: {res.plan}")
    log(f"[smoke] pipeline fused-kernel peak device memory above the call's "
        f"start {peak / 2**20:.1f} MiB (limit "
        f"{DEFAULT_MATRIX_BUDGET / 2**20:.0f} MiB; one (n, n) f32 buffer "
        f"is {4 * EMP_N ** 2 / 2**20:.0f} MiB)")
    check(res.plan.startswith("braycurtis.fusedk.cuda[")
          and "-> fused-kernel(" in res.plan,
          f"expected the fused-kernel bridge, got {res.plan!r}")
    check(res.method == "pipeline[braycurtis.cuda->fused-kernel->matmul]",
          f"unexpected method {res.method!r}")
    chunk, launches = fused_plan()
    check(f"stream(chunk={chunk})" in res.plan,
          f"expected the plan's chunk {chunk}, got {res.plan!r}")
    want = {k: 0 for k in paths["fused-kernel"]}
    want["fused_sw"] = launches
    check(paths["fused-kernel"] == want,
          f"fused-kernel bridge launches {paths['fused-kernel']} != {want}")
    check(res.f_perms.device == dev and res.f_perms.shape == (EMP_PERMS + 1,)
          and bool(torch.isfinite(res.f_perms).all()),
          "null distribution must be finite, (n_perms + 1,), on the card")
    for name, (f, p) in (("phase 3 engine.run", (f0, p0)),
                         ("the dense bridge", (f_d, p_d))):
        check(abs(f_k - f) <= RTOL * abs(f) and p_k == p,
              f"fused-kernel bridge F={f_k} p={p_k} vs {name} F={f} p={p}")
    check(peak < DEFAULT_MATRIX_BUDGET,
          f"fused-kernel bridge peak {peak} B >= the matrix budget")
    null_within_f32("fused-kernel", res.f_perms, null_d)
    del res

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipeline.pipeline(x, g_dev, metric="braycurtis",
                            n_perms=CROSS_PERMS, seed=0, materialize="fused",
                            device=dev)
    f_f, p_f = float(res.f_stat), float(res.p_value)          # waits
    dt = time.perf_counter() - t0
    paths["fused"] = launch_counts()
    log(f"[smoke] pipeline fused n={EMP_N} perms={CROSS_PERMS} {dt:.3f}s end "
        f"to end F={f_f:.7g} p={p_f:.6g} launches={paths['fused']}")
    log(f"[smoke] pipeline fused plan: {res.plan}")
    want = {k: 0 for k in paths["fused"]}
    want["braycurtis"] = -(-EMP_N // STREAM_ROWS)
    check(paths["fused"] == want,
          f"fused bridge launches {paths['fused']} != {want}")
    null_1000 = null_d[:CROSS_PERMS + 1]
    check(abs(f_f - f_d) <= RTOL * abs(f_d),
          f"fused bridge F={f_f} vs the dense bridge's F={f_d}")
    null_within_f32("fused", res.f_perms, null_1000)
    p_1000 = float(p_value_from_null(null_1000))
    check(p_f == p_1000, f"fused bridge p={p_f} != {p_1000} of the dense "
          "bridge's first 1,000")
    log(f"[smoke] pipeline fused p {p_f} == {p_1000} of the dense bridge's "
        "first 1,000")
    return paths


def null_within_f32(bridge, null, null_dense):
    """A bridge's null F against the dense bridge's on the same labels,
    within what f32 s_W allows at the EMP shape (see SW_MAIN_RTOL): rtol
    on F itself would not do, since a null F is ~1 while an f32 error e
    in s_W moves it by ~e (n - G) / (G - 1) ~ 3,600 e."""
    import torch
    c = (EMP_N - EMP_GROUPS) / (EMP_GROUPS - 1)
    tol = 2 * SW_MAIN_RTOL * (null_dense.abs() + c)
    d_null = (null - null_dense).abs()
    excess = float((d_null / tol).max())
    log(f"[smoke] pipeline {bridge} null F vs the dense bridge: max "
        f"{float(d_null.max()):.3e} abs, {excess:.3f} of the f32 allowance "
        f"2*{SW_MAIN_RTOL}*(F + {c:.1f})")
    check(bool(torch.isfinite(null).all()) and excess <= 1.0,
          f"{bridge} bridge null F differs from the dense bridge's by "
          f"{excess:.3g}x the f32 allowance")


def bound_pairs(x_rows, x) -> float:
    """The (row, column) pairs a fused call's function needs: D^2 is
    symmetric with a zero diagonal, so a call over the whole table needs
    each unordered pair once, n (n - 1) / 2, as the s_W bounds count
    them; a row slab needs its nr * n."""
    nr, n = x_rows.shape[0], x.shape[0]
    if x_rows.data_ptr() == x.data_ptr() and nr == n:
        return n * (n - 1) / 2
    return float(nr * n)


def fused_bound_ms(x_rows, x, labels, inv_gs, chip) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time this card could take
    for one fused call — its inputs (row slab, table, row and column
    labels, inv_gs) read once and s_W and the row sums written once at
    the HBM rate, against its operations at the f32 CUDA-core peak: 2 per
    (pair, feature) to build D^2, and a compare per (pair, permutation)
    plus an add per matching pair for s_W, each pair once (bound_pairs)."""
    import torch
    nr, n, d = x_rows.shape[0], x.shape[0], x.shape[1]
    p, g = labels.shape[0], inv_gs.shape[0]
    nbytes = 4 * (nr * d + n * d + p * nr + p * n + g + p + nr)
    sizes = torch.bincount(labels[0].long(), minlength=g).double()
    matches = float((sizes * (sizes - 1) / 2).sum())
    ops_ = 2.0 * bound_pairs(x_rows, x) * d + p * (n * (n - 1) / 2
                                                   + matches)
    t_bytes = nbytes / chip.hbm_bandwidth * 1e3
    t_ops = ops_ / chip.peak_flops_f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_own_floors_ms(x, labels, chip) -> tuple:
    """The labels kernel's own floors (its formulation's, not the
    function's bound), each pair of the whole table once as its symmetric
    visit does: (the feature phase's 2 per (pair, feature) at the f32
    peak, one INT32 compare per (pair, permutation) at the INT32 pipe's
    rate as brute's floor counts it)."""
    n, d = x.shape[0], x.shape[1]
    return (n * (n - 1) * d / chip.peak_flops_f32 * 1e3,
            brute_floor_ms(labels))


def phase_fused_timings(dev, x_np, grouping, paths, checked):
    """The fused kernel at P = 1, P = ONEHOT_CHUNK (every earlier row's
    chunk) and the plan's chunk (the main path's), each beside its bound
    (each pair once), its own floors (a time under the larger fails the
    run) and, for scale, one f32 torch.matmul of a resident mat2 with the
    chunk's (n, P G) one-hot factor (the contraction alone; no PyTorch
    call computes features -> s_W); the plain version at P = ONEHOT_CHUNK
    and the plan's chunk; one chunk's label draw, as the path draws it."""
    import torch
    from repro_torch.core import fstat, permutations
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.fused_sw import ops as fops, ref as fref
    from repro_torch.pipeline import planner as pplanner
    x, labels, inv_gs = emp_chunk(dev, x_np, grouping)
    chunk, launches = fused_plan()
    g_dev = torch.from_numpy(grouping).to(dev)
    rows = min(permutations.draw_rows(EMP_N, pplanner.plan_pipeline(
        EMP_N, EMP_FEATURES, EMP_PERMS + 1, EMP_GROUPS,
        backend="cuda").draw_budget), chunk)
    labels_ms = cuda_ms(lambda: permutations.permutation_batch(
        g_dev, chunk, 2 * chunk, seed=0, block_rows=rows), reps=3)
    d = dops.pairwise_distance(x, metric="braycurtis")
    mat2 = d * d
    del d
    small = x[:64].contiguous()
    small_lab = labels[:, :64].contiguous()
    t = {}
    for p in (1, ONEHOT_CHUNK, chunk):
        lab = labels[:p].contiguous()
        ms = cuda_ms(lambda: fops.fused_sw_rows(x, x, lab, lab, inv_gs, 0),
                     reps=5 if p < chunk else 3)
        b_ms, b_by = fused_bound_ms(x, x, lab, inv_gs, H100_SXM)
        feat_floor, cmp_floor = fused_own_floors_ms(x, lab, H100_SXM)
        floor_ms = max(feat_floor, cmp_floor)
        check(ms > floor_ms, f"fused_sw {ms:.3f} ms at P = {p} reads under "
              f"its own floor {floor_ms:.3f} ms: a count is wrong")
        plain_ms = matmul_ms = None
        if p > 1:
            plain_ms = cuda_ms(
                lambda: fref.fused_sw_ref(x, x, lab, lab, inv_gs, 0),
                reps=1, warm=lambda: fref.fused_sw_ref(
                    small, small, small_lab[:p].contiguous(),
                    small_lab[:p].contiguous(), inv_gs, 0))
            e2d = fstat.onehot_perm_factors(lab, inv_gs, torch.float32) \
                .permute(1, 0, 2).reshape(EMP_N, -1).contiguous()
            matmul_ms = cuda_ms(lambda: torch.matmul(mat2, e2d), reps=1)
            del e2d
        t[p] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                    contraction_matmul_ms=matmul_ms)
        log(f"[smoke] timing fused_sw  (n={EMP_N}, d={EMP_FEATURES}, "
            f"P={p}, G={EMP_GROUPS}) f32: kernel {ms:.3f} ms, plain "
            f"{plain_ms} ms, library none, bound {b_ms:.3f} ms ({b_by}, "
            f"each pair once), {b_ms / ms * 100:.1f}% of it; its own floors "
            f"{feat_floor:.3f} ms of feature phase at the f32 peak, "
            f"{cmp_floor:.3f} ms of INT32 compares, {floor_ms / ms * 100:.1f}"
            f"% of the kernel's time for the larger; contraction-only "
            f"torch.matmul of mat2 with the (n, P*G) one-hot factor "
            f"{matmul_ms} ms")
    del mat2
    ms, ms_one = t[chunk]["ms"], t[1]["ms"]
    per_perm = (ms - ms_one) / (chunk - 1)
    last = EMP_PERMS + 1 - (launches - 1) * chunk
    log(f"[smoke] timing fused_sw  the plan's chunk {chunk}: {ms:.3f} ms x "
        f"{launches} launches (the last of {last} slots); P=1 (feature "
        f"phase + one 128-permutation pass) {ms_one:.3f} ms, so "
        f"~{per_perm:.4f} ms per further permutation (P={ONEHOT_CHUNK}: "
        f"{t[ONEHOT_CHUNK]['ms']:.3f} ms); labels of one chunk "
        f"{labels_ms:.3f} ms in sub-blocks of {rows} rows (x {launches} = "
        f"{labels_ms * launches:.1f} ms)")
    return {
        "name": "fused_sw", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": FUSED_REPLACES, "path": "pipeline fused-kernel",
        "launches": paths["fused-kernel"]["fused_sw"],
        "launches_by_path": {k: c["fused_sw"] for k, c in paths.items()},
        "max_abs_err": checked["max_abs_err"], "ms": ms,
        "plain_ms": t[chunk]["plain_ms"], "bound_ms": t[chunk]["bound_ms"],
        "bound_by": t[chunk]["bound_by"], "library_ms": None,
        "library": "none: no PyTorch call computes features -> s_W",
        "shape": {"n": EMP_N, "d": EMP_FEATURES, "P": chunk,
                  "G": EMP_GROUPS},
        "contraction_matmul_ms": t[chunk]["contraction_matmul_ms"],
        "at_p": {str(p): v for p, v in t.items()},
        "max_rel_err": checked["max_rel_err"],
        "max_rel_err_checks": checked["max_rel_err_checks"],
        "ms_one_perm": ms_one, "ms_per_further_perm": per_perm,
        "labels_ms_per_chunk": labels_ms,
    }


def design_basis(n, k, p, seed, device):
    """A permuted dense-design basis (p, n, k) as the design path builds
    it: core.design.build of a grouping (G = 2 for K = 3, else 8) and K -
    G standard-normal covariates, rows gathered by p free index
    permutations (identity first)."""
    import numpy as np
    import torch
    from repro_torch.core import design, fstat, permutations
    rng = np.random.default_rng(seed)
    g = 2 if k == 3 else 8
    grouping = rng.integers(0, g, size=n).astype(np.int32)
    grouping[:g] = np.arange(g)
    des = design.build(grouping=grouping,
                       covariates=rng.normal(size=(n, k - g)), n_groups=g,
                       device=device)
    check(des.k_cols == k, f"design basis has {des.k_cols} columns, not {k}")
    perms = permutations.strata_permutation_batch(
        torch.zeros(n, dtype=torch.int32, device=device), 0, p, seed=seed)
    return fstat.basis_perm_factors(des.basis, perms).contiguous()


def emp_design(dev, x_np, grouping, **kw):
    """The EMP design columns (synthetic_design, seed 0) and the dense
    design the default path builds from them (no strata, no weights
    unless kw asks)."""
    from repro_torch.core import design
    from repro_torch.data.microbiome import synthetic_design
    cov, strata, weights = synthetic_design(
        EMP_N, covariate_names=DESIGN_COVARIATES, n_strata=DESIGN_STRATA,
        weighted=True, seed=0)
    return cov, strata, weights, design.build(
        grouping=grouping, covariates=cov, n_groups=EMP_GROUPS, device=dev,
        **kw)


def emp_cols_chunk(dev, x_np, grouping):
    """The design path's first fused_sw_cols chunk: the EMP features, the
    first cols_plan()[0] index permutations of seed 0 (free: no strata) and
    the permuted basis."""
    import torch
    from repro_torch.core import fstat, permutations
    *_, des = emp_design(dev, x_np, grouping)
    x = torch.from_numpy(x_np).to(dev)
    perms = permutations.strata_permutation_batch(
        torch.zeros(EMP_N, dtype=torch.int32, device=dev), 0, cols_plan()[0],
        seed=0)
    return x, fstat.basis_perm_factors(des.basis, perms).contiguous()


def phase_cols_kernel(dev, x_np, grouping):
    """fused_sw_cols against its plain version at COLS_CHECK_SHAPES, offset
    slabs (one all pad) and chunk splits at n = 2047, and the EMP design
    chunk. Returns its errors for the kernels line."""
    import torch
    from repro_torch.core.distance import ROW_METRICS
    from repro_torch.data.microbiome import synthetic_abundance
    from repro_torch.kernels.fused_sw import ops as fops, ref as fref
    worst_rel = 0.0
    for n, d, p, k in COLS_CHECK_SHAPES:
        x = torch.from_numpy(synthetic_abundance(n, d, seed=n + d)).to(dev)
        v = design_basis(n, k, p, n + d + k, dev)
        for metric in fops.FUSED_METRICS:
            xp = ROW_METRICS[metric].prepare(x).contiguous()
            sc, rs = fops.fused_sw_rows_cols(xp, xp, v, v, 0, metric=metric)
            sc_p, rs_p = fref.fused_sw_cols_ref(xp, xp, v, v, 0,
                                                metric=metric)
            torch.cuda.synchronize()
            err = rel_err(sc, sc_p)
            worst_rel = max(worst_rel, err)
            check(sc.shape == (p, k) and rs.shape == (n,)
                  and bool(torch.isfinite(sc).all())
                  and torch.allclose(sc, sc_p, rtol=FUSED_RTOL, atol=ATOL)
                  and torch.allclose(rs, rs_p, rtol=FUSED_RTOL, atol=ATOL),
                  f"fused_sw_cols {metric} != plain at {(n, d, p, k)}: "
                  f"s_cols rel {err:.3e}, row sums abs "
                  f"{float((rs - rs_p).abs().max()):.3e}")
            log(f"[smoke] kernel fused_sw_cols {metric:10s} (n,d,P,K)="
                f"{(n, d, p, k)} s_cols max_rel_err={err:.3e} row sums "
                f"max_rel_err={rel_err(rs, rs_p):.3e} vs plain")
            if n < 2047:
                continue
            # the table padded with zero rows (and zero basis rows) past
            # n_valid = n: its 300-row slabs sum to the unpadded call, and
            # the last one, all pad rows, gives exact zeros
            pad = PAD_ROWS - n
            xq = torch.nn.functional.pad(xp, (0, 0, 0, pad)).contiguous()
            vq = torch.nn.functional.pad(v, (0, 0, 0, pad)).contiguous()
            parts = [fops.fused_sw_rows_cols(
                xq[lo:lo + SLAB_ROWS].contiguous(), xq,
                vq[:, lo:lo + SLAB_ROWS].contiguous(), vq, lo,
                metric=metric, n_valid=n)
                for lo in range(0, PAD_ROWS, SLAB_ROWS)]
            sc_s = torch.stack([q[0] for q in parts]).sum(dim=0)
            rs_s = torch.cat([q[1] for q in parts])
            check(torch.allclose(sc_s, sc, rtol=SLAB_RTOL, atol=ATOL)
                  and torch.allclose(rs_s[:n], rs, rtol=SLAB_RTOL, atol=0)
                  and bool((parts[-1][0] == 0).all())
                  and bool((rs_s[n:] == 0).all()),
                  f"fused_sw_cols {metric}: {len(parts)} offset slabs of "
                  f"{SLAB_ROWS} rows (n_valid {n}) != the full call")
            # the whole padded table in one call (the kernel's symmetric
            # visit with pad rows past n_valid) gives the unpadded call too
            sc_q, rs_q = fops.fused_sw_rows_cols(xq, xq, vq, vq, 0,
                                                 metric=metric, n_valid=n)
            check(torch.allclose(sc_q, sc, rtol=SLAB_RTOL, atol=ATOL)
                  and torch.allclose(rs_q[:n], rs, rtol=SLAB_RTOL, atol=0)
                  and bool((rs_q[n:] == 0).all()),
                  f"fused_sw_cols {metric}: the padded table (n_valid {n}) "
                  f"!= the unpadded call: rel {rel_err(sc_q, sc):.3e}")
            split = SPLITS[0]
            bounds = [0, split[0], split[0] + split[1], sum(split)]
            sc_c = torch.cat([fops.fused_sw_rows_cols(
                xp, xp, v[a:b].contiguous(), v[a:b].contiguous(), 0,
                metric=metric)[0] for a, b in zip(bounds, bounds[1:])])
            check(torch.allclose(sc_c, sc, rtol=SPLIT_RTOL, atol=0),
                  f"fused_sw_cols {metric}: chunks {split} != one call of "
                  f"{sum(split)}: rel {rel_err(sc_c, sc):.3e}")
            log(f"[smoke] kernel fused_sw_cols {metric:10s} n={n}: "
                f"{len(parts)} offset slabs of the {PAD_ROWS}-row "
                f"padded table sum to the full call (rel "
                f"{rel_err(sc_s, sc):.3e}; the all-pad slab gives zeros), "
                f"the padded table in one call equals it (rel "
                f"{rel_err(sc_q, sc):.3e}), "
                f"chunks {split} equal one call (rel "
                f"{rel_err(sc_c, sc):.3e})")
    worst_rel = max(worst_rel, cols_odd_checks(dev))
    x, v = emp_cols_chunk(dev, x_np, grouping)
    sc, rs = fops.fused_sw_rows_cols(x, x, v, v, 0)
    sc_p, rs_p = fref.fused_sw_cols_ref(x, x, v, v, 0)
    torch.cuda.synchronize()
    s_t = float(rs_p.double().sum()) / 2.0 / EMP_N
    err_abs = float((sc - sc_p).abs().max())
    check(bool(torch.isfinite(sc).all())
          and err_abs <= SW_MAIN_RTOL * s_t
          and torch.allclose(rs, rs_p, rtol=FUSED_RTOL, atol=ATOL),
          f"fused_sw_cols != plain at the EMP design chunk: s_cols abs "
          f"{err_abs:.3e} > {SW_MAIN_RTOL} * s_T = {SW_MAIN_RTOL * s_t:.3e}")
    log(f"[smoke] kernel fused_sw_cols braycurtis (n,d,P,K)="
        f"{(EMP_N, EMP_FEATURES, cols_plan()[0], DESIGN_K)} s_cols max_abs_err="
        f"{err_abs:.3e} = {err_abs / s_t:.3e} s_T (limit {SW_MAIN_RTOL} "
        f"s_T, s_T = {s_t:.6g}); row sums max_rel_err={rel_err(rs, rs_p):.3e}"
        f"; workspace {fops.cols_workspace_bytes(EMP_N, EMP_N, cols_plan()[0], DESIGN_K) / 2**20:.2f} MiB")
    sc_t = cols_tf32_stand_in(x, v)
    err_t = float((sc_t - sc_p).abs().max())
    check(err_t > SW_MAIN_RTOL * s_t,
          f"the {SW_MAIN_RTOL} s_T bar lets a TF32 contraction pass: "
          f"{err_t / s_t:.3e} s_T")
    log(f"[smoke] kernel fused_sw_cols EMP design chunk, TF32 stand-in "
        f"(the plain version's blocks contracted by TF32 matmuls): s_cols "
        f"max_abs_err="
        f"{err_t:.3e} = {err_t / s_t:.3e} s_T against the f32 plain version "
        f"({err_t / (SW_MAIN_RTOL * s_t):.3g}x the {SW_MAIN_RTOL} s_T bar)")
    return {"max_abs_err": err_abs, "max_abs_err_over_s_t": err_abs / s_t,
            "max_rel_err_checks": worst_rel}


def cols_odd_checks(dev) -> float:
    """fused_sw_cols in every feature mode at COLS_ODD (odd n, K = 1, P * K
    past two 128-q passes, unit basis columns), as the symmetric
    whole-table call and as the row slab COLS_ODD_SLAB at its offset,
    against the plain version in the same mode: rtol FUSED_RTOL, atol
    ATOL, and every entry within SW_MAIN_RTOL * s_T. Returns the worst
    relative error."""
    import torch
    from repro_torch.core.distance import ROW_METRICS
    from repro_torch.data.microbiome import synthetic_abundance
    from repro_torch.kernels.fused_sw import ops as fops, ref as fref
    from repro_torch.pipeline.registry import precision_tuning
    n, d, p, k = COLS_ODD
    lo, hi = COLS_ODD_SLAB
    x = torch.from_numpy(synthetic_abundance(n, d, seed=n + d)).to(dev)
    # a random basis of unit columns, the scale of the design's
    # orthonormal ones (an entry's error grows with |v|^2 against s_T)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + p)
    v = torch.randn((p, n, k), generator=gen, device=dev)
    v = (v / v.norm(dim=1, keepdim=True)).contiguous()
    vs = v[:, lo:hi].contiguous()
    worst = 0.0
    for tag, metric in [("f32", m) for m in fops.FUSED_METRICS] + \
            mode_cases():
        kn = precision_tuning(tag) if tag != "f32" else {}
        xp = ROW_METRICS[metric].prepare(x).contiguous()
        xs = xp[lo:hi].contiguous()
        for part, args in (("symmetric", (xp, xp, v, v, 0)),
                           (f"slab [{lo}, {hi})", (xs, xp, vs, v, lo))):
            sc, rs = fops.fused_sw_rows_cols(*args, metric=metric, **kn)
            sc_p, rs_p = fref.fused_sw_cols_ref(*args, metric=metric, **kn)
            torch.cuda.synchronize()
            if part == "symmetric":     # s_T from the whole table's rows
                s_t = float(rs_p.double().sum()) / 2.0 / n
            err = rel_err(sc, sc_p)
            err_t = float((sc - sc_p).abs().max()) / s_t
            worst = max(worst, err)
            check(sc.shape == (p, k) and rs.shape == (args[0].shape[0],)
                  and bool(torch.isfinite(sc).all())
                  and torch.allclose(sc, sc_p, rtol=FUSED_RTOL, atol=ATOL)
                  and torch.allclose(rs, rs_p, rtol=FUSED_RTOL, atol=ATOL)
                  and err_t <= SW_MAIN_RTOL,
                  f"fused_sw_cols[{tag}] {metric} {part} != plain at "
                  f"{COLS_ODD}: s_cols rel {err:.3e}, {err_t:.3e} s_T")
            log(f"[smoke] kernel fused_sw_cols[{tag}] {metric:10s} "
                f"(n,d,P,K)={COLS_ODD} {part}: s_cols max_rel_err="
                f"{err:.3e}, {err_t:.3e} s_T; row sums max_rel_err="
                f"{rel_err(rs, rs_p):.3e} vs plain")
    return worst


def cols_tf32_stand_in(x, v):
    """(P, K) s_cols of the plain fused_sw_cols version's masked D^2 blocks
    each contracted by an f32 torch.matmul in TF32 (the blocks summed in
    float64): a lower-precision stand-in the 1e-6 s_T bar must reject.
    (The plain version itself contracts in float64, where TF32 does not
    apply.)"""
    import torch
    from repro_torch.core import fstat
    from repro_torch.kernels.fused_sw import ref as fref
    s = torch.zeros((v.shape[0], v.shape[2]), dtype=torch.float64,
                    device=x.device)
    with tf32_matmuls():
        for lo, hi, m2 in fref._masked_d2_blocks(
                x, x, 0, "braycurtis", x.shape[0],
                dict(feat_bf16=0, feat_fp8=0, feat_packed=0,
                     feat_scale=None)):
            s += fstat.sw_cols_contract(m2, v, v[:, lo:hi]).double()
        torch.cuda.synchronize()
    return s.to(torch.float32)


@contextlib.contextmanager
def tf32_matmuls():
    """torch.matmul in TF32 inside the block (a lower-precision stand-in
    for the f32 contractions), switched back off on leaving it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def design_null_allowance(res, k):
    """Per-term f32 allowance on F between two paths on the same
    permutations. Each column's form s_k is held within SW_MAIN_RTOL * s_T
    of its plain version, so two paths differ by up to 2 e, e =
    SW_MAIN_RTOL * s_T, on each of the K columns. With SS_t = -sum over
    the term's df columns and SS_resid = sum over all K,
    F_t = (SS_t / df) / (SS_resid / dof) moves by at most
    2 e (K F_t + dof) / SS_resid; SS_resid is taken as the observed one,
    the smallest of the null's under an effect (a larger allowance)."""
    dof = res.n_objects - sum(t.df for t in res.terms) - 1
    e = SW_MAIN_RTOL * float(res.s_t)
    return {t.name: 2.0 * e * (k * t.f_perms.abs() + dof) / float(res.s_w)
            for t in res.terms}


def design_path_faults(tag, res, ref, allow) -> dict:
    """Per-term F, null and p of `res` against `ref` (the dense bridge on
    the same seed): observed F at rtol RTOL, every null F within allow[t]
    (a tensor over the null), and p apart by at most the null F that lie
    within the allowance of the observed F, over n_perms + 1. Logs each
    term; returns {term: [the bars it misses]}."""
    import torch
    n_total = res.n_perms + 1
    faults = {}
    for t, u in zip(res.terms, ref.terms):
        check(t.name == u.name and t.df == u.df, f"{tag}: terms differ")
        f, g = float(t.f_stat), float(u.f_stat)
        a = allow[t.name]
        d_null = (t.f_perms - u.f_perms).abs()
        excess = float((d_null / a).max())
        near = int(((u.f_perms[1:] - u.f_perms[0]).abs()
                    <= a[1:] + a[0]).sum())
        dp = abs(float(t.p_value) - float(u.p_value)) * n_total
        log(f"[smoke] design {tag} {t.name:8s} df={t.df} F={f:.7g} vs "
            f"{g:.7g} (rel {abs(f - g) / abs(g):.3e}) p={float(t.p_value):.6g}"
            f" vs {float(u.p_value):.6g}; null max "
            f"{float(d_null.max()):.3e} abs, {excess:.3e} of the f32 "
            f"allowance, {int((d_null > a).sum())} outside it; {near} null "
            f"F within it of the observed")
        faults[t.name] = [m for bad, m in (
            (abs(f - g) > RTOL * abs(g), f"observed F {f} vs {g} at rtol "
             f"{RTOL}"),
            (not bool(torch.isfinite(t.f_perms).all()) or excess > 1.0,
             f"null F differs by {excess:.3g}x the f32 allowance"),
            (round(dp) > near, f"p differs by {dp:.0f}/{n_total}, more "
             f"than the {near} null F within the allowance")) if bad]
    return faults


def check_design_paths(tag, res, ref, allow):
    """design_path_faults of `res` against `ref`: every term meets every
    bar."""
    for name, missed in design_path_faults(tag, res, ref, allow).items():
        check(not missed, f"{tag} {name}: {'; '.join(missed)}")


def phase_design_pipeline(dev, x_np, grouping):
    """pipeline() at the EMP shape with the default budgets for four
    designs, each with its own launch counts and peak memory; (a) and
    (c) again through the dense bridge. Returns the launch counts by
    path."""
    import torch
    from repro_torch import pipeline
    x = torch.from_numpy(x_np).to(dev)
    g_dev = torch.from_numpy(grouping).to(dev)
    cov, strata, weights, _ = emp_design(dev, x_np, grouping)
    runs = {"covariates": dict(covariates=cov),
            "covariates+weights": dict(covariates=cov, weights=weights),
            "strata": dict(strata=strata),
            "covariates+strata": dict(covariates=cov, strata=strata)}
    paths, results = {}, {}
    for tag, kw in runs.items():
        zero_launches()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = pipeline.pipeline(x, g_dev, metric="braycurtis",
                                n_perms=EMP_PERMS, seed=0, device=dev, **kw)
        f_k, p_k = float(res.f_stat), float(res.p_value)          # waits
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - start
        paths[tag] = launch_counts()
        results[tag] = res
        log(f"[smoke] design {tag} n={EMP_N} perms={EMP_PERMS} default "
            f"budgets {dt:.3f}s end to end F={f_k:.7g} p={p_k:.6g} "
            f"launches={paths[tag]} peak device memory above the call's "
            f"start {peak / 2**20:.1f} MiB")
        log(f"[smoke] design {tag} plan: {res.plan}")
        want = {c: 0 for c in paths[tag]}
        if tag == "strata":
            want["fused_sw"] = strata_plan()[1]
            check(res.method == "pipeline[fused-kernel:cuda+strata]",
                  f"unexpected method {res.method!r}")
        else:
            want["fused_sw_cols"] = cols_plan()[1]
            check(res.method == "pipeline-design[fused-kernel:cuda]"
                  and f"chunks={cols_plan()[1]} " in res.plan
                  and f" cols={DESIGN_K} " in res.plan,
                  f"unexpected method/plan {res.method!r} {res.plan!r}")
        check(paths[tag] == want,
              f"design {tag} launches {paths[tag]} != {want}")
        check(peak < DEFAULT_MATRIX_BUDGET,
              f"design {tag} peak {peak} B >= the matrix budget")
        check(res.terms is not None and all(
            t.f_perms.device == dev and t.f_perms.shape == (EMP_PERMS + 1,)
            and bool(torch.isfinite(t.f_perms).all()) for t in res.terms),
            f"design {tag}: per-term nulls must be finite on the card")
        for t in res.terms:
            log(f"[smoke] design {tag} term {t.name:8s} df={t.df} "
                f"F={float(t.f_stat):.7g} R2={float(t.r2):.4g} "
                f"p={float(t.p_value):.6g}")

    for tag in ("covariates", "strata"):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipeline.pipeline(x, g_dev, metric="braycurtis",
                                n_perms=EMP_PERMS, seed=0,
                                matrix_budget_bytes=BRIDGE_BUDGETS["dense"],
                                device=dev, **runs[tag])
        f_d = float(res.f_stat)                                   # waits
        dt = time.perf_counter() - t0
        path = launch_counts()
        paths[f"{tag} dense"] = path
        log(f"[smoke] design {tag} dense bridge {dt:.3f}s F={f_d:.7g} "
            f"launches={path} plan: {res.plan.split(' | ')[0]} :: "
            f"{res.plan.split(' :: ', 1)[1]}")
        want = {c: 0 for c in path}
        want["braycurtis"] = 1
        if tag == "strata":
            want["brute"] = 2
        check(path == want, f"design {tag} dense launches {path} != {want}")
        if tag == "strata":
            c = (EMP_N - EMP_GROUPS) / (EMP_GROUPS - 1)
            allow = {res.terms[0].name:
                     2 * SW_MAIN_RTOL * (res.f_perms.abs() + c)}
        else:
            allow = design_null_allowance(res, DESIGN_K)
        check_design_paths(tag, results[tag], res, allow)
        del res
        if tag == "covariates":
            with tf32_matmuls():
                alt = pipeline.pipeline(
                    x, g_dev, metric="braycurtis", n_perms=EMP_PERMS,
                    seed=0, matrix_budget_bytes=BRIDGE_BUDGETS["dense"],
                    device=dev, **runs[tag])
                torch.cuda.synchronize()
            faults = design_path_faults(f"{tag} TF32 stand-in",
                                        results[tag], alt, allow)
            check(all(faults.values()),
                  f"the per-term bars let a TF32 dense bridge pass: "
                  f"{faults}")
            log(f"[smoke] design {tag}: the per-term bars reject the TF32 "
                f"stand-in in every term: {faults}")
            del alt
    return paths


def cols_bound_ms(x_rows, x, v, chip) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time this card could take
    for one fused_sw_cols call — its inputs (row slab, table, both basis
    factors) read once and s_cols and the row sums written once at the
    HBM rate, against its operations at the f32 CUDA-core peak: 2 per
    (pair, feature) to build D^2 and 2 per (pair, permutation, column)
    for the per-column forms (a multiply-add of D^2 v_c into each row's
    sum; the O(n P K) outer product with v_r is left out), each pair once
    (bound_pairs)."""
    nr, n, d = x_rows.shape[0], x.shape[0], x.shape[1]
    p, k = v.shape[0], v.shape[2]
    nbytes = 4 * (nr * d + n * d + p * nr * k + p * n * k + p * k + nr)
    ops_ = 2.0 * bound_pairs(x_rows, x) * (d + p * k)
    t_bytes = nbytes / chip.hbm_bandwidth * 1e3
    t_ops = ops_ / chip.peak_flops_f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cols_own_floors_ms(x, v, chip) -> tuple:
    """The dense-design kernel's own floors (its formulation's, not the
    function's bound), halved by its symmetric visit of the tiles j >= i:
    (the feature phase's 2 n^2 d / 2 at the f32 peak, the product's three
    TF32 passes of 2 n^2 P K / 2 at the dense TF32 peak)."""
    n, d = x.shape[0], x.shape[1]
    q = v.shape[0] * v.shape[2]
    return (n * n * d / chip.peak_flops_f32 * 1e3,
            3 * n * n * q / TC_TF32 * 1e3)


def phase_cols_timings(dev, x_np, grouping, paths, checked):
    """fused_sw_cols at the EMP design chunk beside its plain version and
    its bound, at P = 1, and one f32 torch.matmul of a resident mat2 with
    the chunk's (n, P*K) basis factor."""
    import torch
    from repro_torch.core import fstat, permutations
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.fused_sw import ops as fops, ref as fref
    x, v = emp_cols_chunk(dev, x_np, grouping)
    _, strata, _, des = emp_design(dev, x_np, grouping)
    free = torch.zeros(EMP_N, dtype=torch.int32, device=dev)
    blocks = torch.from_numpy(strata).to(dev)
    draw_ms, draw_strata_ms = (cuda_ms(
        lambda st=st: permutations.strata_permutation_batch(
            st, cols_plan()[0], 2 * cols_plan()[0], seed=0), reps=5)
        for st in (free, blocks))
    idx = permutations.strata_permutation_batch(free, cols_plan()[0],
                                                2 * cols_plan()[0], seed=0)
    gather_ms = cuda_ms(lambda: fstat.basis_perm_factors(des.basis, idx),
                        reps=5)
    del idx
    one = v[:1].contiguous()
    ms_one = cuda_ms(lambda: fops.fused_sw_rows_cols(x, x, one, one, 0),
                     reps=5)
    ms = cuda_ms(lambda: fops.fused_sw_rows_cols(x, x, v, v, 0), reps=3)
    small, small_v = x[:64].contiguous(), v[:, :64].contiguous()
    plain_ms = cuda_ms(
        lambda: fref.fused_sw_cols_ref(x, x, v, v, 0), reps=1,
        warm=lambda: fref.fused_sw_cols_ref(small, small, small_v, small_v,
                                            0))
    d = dops.pairwise_distance(x, metric="braycurtis")
    mat2 = d * d
    del d
    v2d = v.permute(1, 0, 2).reshape(EMP_N, -1).contiguous()
    matmul_ms = cuda_ms(lambda: torch.matmul(mat2, v2d), reps=3)
    del mat2, v2d
    b_ms, b_by = cols_bound_ms(x, x, v, H100_SXM)
    # the two phases run on different units, so the larger is the floor
    feat_floor, tc_floor = cols_own_floors_ms(x, v, H100_SXM)
    floor_ms = max(feat_floor, tc_floor)
    check(ms > floor_ms, f"fused_sw_cols {ms:.3f} ms reads under its own "
          f"floor {floor_ms:.3f} ms: a count is wrong")
    ws = fops.cols_workspace_bytes(EMP_N, EMP_N, cols_plan()[0], DESIGN_K)
    log(f"[smoke] timing fused_sw_cols (n={EMP_N}, d={EMP_FEATURES}, "
        f"P={cols_plan()[0]}, K={DESIGN_K}) f32: kernel {ms:.3f} ms x "
        f"{cols_plan()[1]} launches = {ms * cols_plan()[1]:.1f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
        f"{b_ms / ms * 100:.1f}% of it; its own floors (the symmetric "
        f"half) {feat_floor:.3f} ms of feature phase at the f32 peak, "
        f"{tc_floor:.3f} ms of three TF32 products at {TC_TF32 / 1e12:.0f} "
        f"TFLOP/s, {floor_ms / ms * 100:.1f}% of the kernel's time for the "
        f"larger; contraction-only torch.matmul of "
        f"mat2 with the (n, P*K) factor {matmul_ms:.3f} ms; workspace "
        f"{ws} B")
    per_q = (ms - ms_one) / ((cols_plan()[0] - 1) * DESIGN_K)
    log(f"[smoke] timing fused_sw_cols split: P=1 (feature phase + K "
        f"columns of one permutation) {ms_one:.3f} ms, so ~{per_q:.5f} ms "
        f"per further (permutation, column); a chunk's index draw "
        f"{draw_ms:.3f} ms free, {draw_strata_ms:.3f} ms within "
        f"{DESIGN_STRATA} strata, its basis gather {gather_ms:.3f} ms (x "
        f"{cols_plan()[1]} = {(draw_ms + gather_ms) * cols_plan()[1]:.1f} ms "
        f"free)")
    return {
        "name": "fused_sw_cols", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": COLS_REPLACES, "path": "pipeline fused-kernel (design)",
        "launches": paths["covariates"]["fused_sw_cols"],
        "launches_by_path": {k: c["fused_sw_cols"]
                             for k, c in paths.items()},
        "max_abs_err": checked["max_abs_err"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "library": "none: no PyTorch call computes features -> per-column "
                   "forms",
        "contraction_matmul_ms": matmul_ms,
        "shape": {"n": EMP_N, "d": EMP_FEATURES, "P": cols_plan()[0],
                  "K": DESIGN_K},
        "max_abs_err_over_s_t": checked["max_abs_err_over_s_t"],
        "max_rel_err_checks": checked["max_rel_err_checks"],
        "ms_one_perm": ms_one, "workspace_bytes": ws,
        "index_draw_ms_per_chunk": draw_ms,
        "index_draw_strata_ms_per_chunk": draw_strata_ms,
        "basis_gather_ms_per_chunk": gather_ms,
    }


def mode_cases():
    """(tag, metric) of every feature mode's kernel checks."""
    return [(tag, m) for tag, ms in MODE_METRICS.items() for m in ms]


def fp8_bytes_match(xp, metric) -> bool:
    """The e4m3 bytes the wrapper hands the kernel for xp equal
    core.distance's cast of the same values on the CPU (which the tests
    hold byte for byte to the reference's)."""
    import torch
    from repro_torch.core import distance
    from repro_torch.kernels.fused_sw import ops as fops
    from repro_torch.kernels.fused_sw import ref as fref
    q = fops.quantize_slabs(
        xp, xp, *fref.resolve_precision(xp, metric, feat_fp8=1))[1]
    xc = xp.cpu()
    want = distance.fp8_quantize(xc, distance.fp8_metric_scale(xc, metric))
    return torch.equal(q.view(torch.uint8).cpu(), want.view(torch.uint8))


def cols_f64(xp, v, metric):
    """(P, K) float64 per-column forms of the masked D^2 (an fp64 oracle
    for the Gram-form metrics, euclidean and jaccard: the row primitive
    and the contraction in float64, 2048 rows at a time)."""
    import torch
    from repro_torch.core import fstat
    from repro_torch.kernels.fused_sw import ref as fref
    n = xp.shape[0]
    x64, v64 = xp.double(), v.double()
    s = torch.zeros((v.shape[0], v.shape[2]), dtype=torch.float64,
                    device=xp.device)
    for lo in range(0, n, 2048):
        hi = min(lo + 2048, n)
        d = fref.ROWS_FNS[metric](x64[lo:hi], x64)
        m2 = d * d
        i = torch.arange(lo, hi, device=xp.device)
        m2[i - lo, i] = 0.0
        s += fstat.sw_cols_contract(m2, v64, v64[:, lo:hi])
    return s


def phase_mode_kernels(dev, x_np, grouping):
    """Both fused kernels in each feature mode against their plain
    versions in the same mode, at the check shapes and the EMP chunks;
    packed against the f32 jaccard kernel bit for bit; the fp8 bytes.
    Returns {(kernel, tag, metric): the EMP chunk's errors, drift and
    plain time}."""
    import torch
    from repro_torch.core import fstat
    from repro_torch.core.distance import ROW_METRICS
    from repro_torch.data.microbiome import synthetic_abundance
    from repro_torch.kernels.fused_sw import ops as fops, ref as fref
    from repro_torch.pipeline.registry import precision_tuning
    for (n, d, p, g), (_, _, _, k) in zip(FUSED_CHECK_SHAPES,
                                          COLS_CHECK_SHAPES):
        x, labels, inv_gs = fused_instance(n, d, p, g, n + d + p, dev)
        xv = torch.from_numpy(synthetic_abundance(n, d, seed=n + d)).to(dev)
        v = design_basis(n, k, p, n + d + k, dev)
        for metric in fops.FUSED_METRICS:
            xp = ROW_METRICS[metric].prepare(x).contiguous()
            xq = ROW_METRICS[metric].prepare(xv).contiguous()
            f32 = fops.fused_sw_rows(xp, xp, labels, labels, inv_gs, 0,
                                     metric=metric)
            f32c = fops.fused_sw_rows_cols(xq, xq, v, v, 0, metric=metric)
            for tag in [t for t, m in mode_cases() if m == metric]:
                kn = precision_tuning(tag)
                sw, rs = fops.fused_sw_rows(xp, xp, labels, labels, inv_gs,
                                            0, metric=metric, **kn)
                sw_p, rs_p = fref.fused_sw_ref(xp, xp, labels, labels,
                                               inv_gs, 0, metric=metric,
                                               **kn)
                sc, rc = fops.fused_sw_rows_cols(xq, xq, v, v, 0,
                                                 metric=metric, **kn)
                sc_p, rc_p = fref.fused_sw_cols_ref(xq, xq, v, v, 0,
                                                    metric=metric, **kn)
                torch.cuda.synchronize()
                check(sw.shape == (p,) and rs.shape == (n,)
                      and bool(torch.isfinite(sw).all())
                      and torch.allclose(sw, sw_p, rtol=FUSED_RTOL, atol=ATOL)
                      and torch.allclose(rs, rs_p, rtol=FUSED_RTOL,
                                         atol=ATOL),
                      f"fused_sw[{tag}] {metric} != plain at "
                      f"{(n, d, p, g)}: s_W rel {rel_err(sw, sw_p):.3e}")
                check(sc.shape == (p, k) and bool(torch.isfinite(sc).all())
                      and torch.allclose(sc, sc_p, rtol=FUSED_RTOL, atol=ATOL)
                      and torch.allclose(rc, rc_p, rtol=FUSED_RTOL,
                                         atol=ATOL),
                      f"fused_sw_cols[{tag}] {metric} != plain at "
                      f"{(n, d, p, k)}: s_cols abs "
                      f"{float((sc - sc_p).abs().max()):.3e}")
                extra = ""
                if tag == "packed":
                    check(torch.equal(sw, f32[0]) and torch.equal(rs, f32[1])
                          and torch.equal(sc, f32c[0])
                          and torch.equal(rc, f32c[1]),
                          f"packed != the f32 jaccard kernels at "
                          f"{(n, d, p)}")
                    extra = "; equal to the f32 jaccard kernels bit for bit"
                if tag == "fp8":
                    check(fp8_bytes_match(xp, metric),
                          f"fp8 bytes of the wrapper != the CPU cast "
                          f"({metric}, n={n})")
                    extra = "; fp8 bytes equal the CPU cast"
                log(f"[smoke] mode {tag:6s} {metric:10s} (n,d,P,G|K)="
                    f"{(n, d, p, g)}|{k}: fused_sw s_W max_rel_err="
                    f"{rel_err(sw, sw_p):.3e}, fused_sw_cols s_cols "
                    f"max_abs_err={float((sc - sc_p).abs().max()):.3e} vs "
                    f"plain; s_W drift from f32 {rel_err(sw, f32[0]):.3e}"
                    f"{extra}")

    x, labels, inv_gs = emp_chunk(dev, x_np, grouping)
    _, v = emp_cols_chunk(dev, x_np, grouping)
    emp = {}
    for metric in fops.FUSED_METRICS:
        xp = ROW_METRICS[metric].prepare(x).contiguous()
        small, small_lab = xp[:64].contiguous(), labels[:, :64].contiguous()
        small_v = v[:, :64].contiguous()
        f32 = fops.fused_sw_rows(xp, xp, labels, labels, inv_gs, 0,
                                 metric=metric)
        f32c = fops.fused_sw_rows_cols(xp, xp, v, v, 0, metric=metric)
        if metric in ("euclidean", "jaccard"):
            # the f32 kernel and its plain version against fp64 at the EMP
            # design chunk: which side carries what error
            s64 = cols_f64(xp, v, metric)
            plain = fref.fused_sw_cols_ref(xp, xp, v, v, 0,
                                           metric=metric)[0]
            s_t = float(f32c[1].double().sum()) / 2.0 / EMP_N
            e_k = float((f32c[0].double() - s64).abs().max()) / s_t
            e_p = float((plain.double() - s64).abs().max()) / s_t
            check(e_k <= SW_MAIN_RTOL,
                  f"fused_sw_cols {metric} at the EMP design chunk "
                  f"{e_k:.3e} s_T from fp64 (limit {SW_MAIN_RTOL})")
            # the oracle the kernels are held to must be sharper than
            # the bar it enforces: ORACLE_MARGIN x inside it
            check(e_p * ORACLE_MARGIN <= SW_MAIN_RTOL,
                  f"plain fused_sw_cols {metric} at the EMP design chunk "
                  f"{e_p:.3e} s_T from fp64: not {ORACLE_MARGIN}x inside "
                  f"its {SW_MAIN_RTOL} s_T bar")
            log(f"[smoke] fp64 oracle fused_sw_cols {metric} (n,d,P,K)="
                f"{(EMP_N, EMP_FEATURES, cols_plan()[0], DESIGN_K)}: the f32 "
                f"kernel {e_k:.3e} s_T from fp64 (limit {SW_MAIN_RTOL}), its "
                f"plain version {e_p:.3e} s_T, "
                f"{SW_MAIN_RTOL / max(e_p, 1e-30):.3g}x inside the bar")
            # the label kernel's plain version against fp64 at the EMP
            # chunk: s_W is the one-hot factor's per-column forms summed
            e = fstat.onehot_perm_factors(labels, inv_gs, torch.float32)
            w64 = cols_f64(xp, e, metric).sum(dim=1)
            del e
            plain_w = fref.fused_sw_ref(xp, xp, labels, labels, inv_gs, 0,
                                        metric=metric)[0]
            e_pw = float(((plain_w.double() - w64).abs() / w64).max())
            e_kw = float(((f32[0].double() - w64).abs() / w64).max())
            check(e_pw * ORACLE_MARGIN <= SW_MAIN_RTOL,
                  f"plain fused_sw {metric} at the EMP chunk {e_pw:.3e} "
                  f"from fp64: not {ORACLE_MARGIN}x inside its "
                  f"{SW_MAIN_RTOL} bar")
            log(f"[smoke] fp64 oracle fused_sw {metric} (n,d,P,G)="
                f"{(EMP_N, EMP_FEATURES, labels.shape[0], EMP_GROUPS)}: the "
                f"f32 "
                f"kernel {e_kw:.3e} relative from fp64, its plain version "
                f"{e_pw:.3e}, {SW_MAIN_RTOL / max(e_pw, 1e-30):.3g}x inside "
                f"the {SW_MAIN_RTOL} bar")
            del s64, plain, w64, plain_w
        for tag in [t for t, m in mode_cases() if m == metric]:
            kn = precision_tuning(tag)
            sw, rs = fops.fused_sw_rows(xp, xp, labels, labels, inv_gs, 0,
                                        metric=metric, **kn)
            plain_ms, (sw_p, rs_p) = cuda_ms_once(
                lambda: fref.fused_sw_ref(xp, xp, labels, labels, inv_gs, 0,
                                          metric=metric, **kn),
                warm=lambda: fref.fused_sw_ref(small, small, small_lab,
                                               small_lab, inv_gs, 0,
                                               metric=metric, **kn))
            err = rel_err(sw, sw_p)
            drift = rel_err(sw, f32[0])
            check(bool(torch.isfinite(sw).all()) and err <= SW_MAIN_RTOL
                  and torch.allclose(rs, rs_p, rtol=FUSED_RTOL, atol=ATOL),
                  f"fused_sw[{tag}] {metric} != plain at the EMP chunk: s_W "
                  f"rel {err:.3e} (limit {SW_MAIN_RTOL})")
            check(drift <= MODE_DRIFT[metric],
                  f"fused_sw[{tag}] {metric}: s_W drift from f32 "
                  f"{drift:.3e} > the reference's bar {MODE_DRIFT[metric]}")
            if tag == "packed":
                check(torch.equal(sw, f32[0]) and torch.equal(rs, f32[1]),
                      "packed fused_sw != the f32 jaccard kernel at the EMP "
                      "chunk")
            if tag == "fp8":
                check(fp8_bytes_match(xp, metric),
                      f"fp8 bytes of the wrapper != the CPU cast at the EMP "
                      f"chunk ({metric})")
            emp[("fused_sw", tag, metric)] = {
                "max_abs_err": float((sw - sw_p).abs().max()),
                "max_rel_err": err, "drift": drift, "plain_ms": plain_ms}
            log(f"[smoke] mode {tag:6s} {metric:10s} fused_sw (n,d,P,G)="
                f"{(EMP_N, EMP_FEATURES, labels.shape[0], EMP_GROUPS)} s_W "
                f"max_rel_err={err:.3e} (limit {SW_MAIN_RTOL}) vs plain "
                f"({plain_ms:.3f} ms); s_W drift from the f32 kernel "
                f"{drift:.3e} (the reference's bar {MODE_DRIFT[metric]}, "
                f"{drift / MODE_DRIFT[metric]:.3g}x)")
            del sw_p, rs_p

            sc, rc = fops.fused_sw_rows_cols(xp, xp, v, v, 0, metric=metric,
                                             **kn)
            plain_ms, (sc_p, rc_p) = cuda_ms_once(
                lambda: fref.fused_sw_cols_ref(xp, xp, v, v, 0,
                                               metric=metric, **kn),
                warm=lambda: fref.fused_sw_cols_ref(small, small, small_v,
                                                    small_v, 0,
                                                    metric=metric, **kn))
            s_t = float(rc_p.double().sum()) / 2.0 / EMP_N
            err_abs = float((sc - sc_p).abs().max())
            drift = float((sc - f32c[0]).abs().max()) / s_t
            check(bool(torch.isfinite(sc).all())
                  and err_abs <= SW_MAIN_RTOL * s_t
                  and torch.allclose(rc, rc_p, rtol=FUSED_RTOL, atol=ATOL),
                  f"fused_sw_cols[{tag}] {metric} != plain at the EMP design "
                  f"chunk: s_cols abs {err_abs:.3e} > {SW_MAIN_RTOL} s_T")
            if tag == "packed":
                check(torch.equal(sc, f32c[0]) and torch.equal(rc, f32c[1]),
                      "packed fused_sw_cols != the f32 jaccard kernel at the "
                      "EMP design chunk")
            emp[("fused_sw_cols", tag, metric)] = {
                "max_abs_err": err_abs, "max_abs_err_over_s_t": err_abs / s_t,
                "drift_over_s_t": drift, "plain_ms": plain_ms}
            log(f"[smoke] mode {tag:6s} {metric:10s} fused_sw_cols "
                f"(n,d,P,K)={(EMP_N, EMP_FEATURES, cols_plan()[0], DESIGN_K)} "
                f"s_cols max_abs_err={err_abs / s_t:.3e} s_T (limit "
                f"{SW_MAIN_RTOL} s_T) vs plain ({plain_ms:.3f} ms); drift "
                f"from the f32 kernel {drift:.3e} s_T")
            del sc_p, rc_p
    return emp


def mode_run(dev, tag, metric, x, g_dev, tuning, **kw):
    """pipeline() at the EMP shape at a precision (tuning), with its own
    launch counts, wall time and peak device memory above its start; it
    fails if the peak, less the run's feature copies (feature_copies),
    exceeds the label budget."""
    from repro_torch.engine import planner as eplanner
    import torch
    from repro_torch import pipeline
    zero_launches()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pipeline.pipeline(x, g_dev, metric=metric, n_perms=EMP_PERMS,
                            seed=0, device=dev, fused_tuning=tuning, **kw)
    f, p = float(res.f_stat), float(res.p_value)              # waits
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    counts = launch_counts()
    copies = feature_copies(x, metric, tuning)
    budget = eplanner.DEFAULT_STREAM_BUDGET_BYTES
    log(f"[smoke] precision {tag} {metric} n={EMP_N} perms={EMP_PERMS} "
        f"{dt:.3f}s end to end F={f:.7g} p={p:.6g} peak device memory "
        f"above the call's start {peak / 2**20:.1f} MiB, less its feature "
        f"copies {(peak - copies) / 2**20:.1f} MiB of the "
        f"{budget / 2**20:.0f} MiB budget, launches="
        f"{ {k: c for k, c in counts.items() if c} }")
    check(peak - copies <= budget,
          f"precision {tag} {metric}: peak {peak} B less its feature "
          f"copies {copies} B exceeds the {budget} B budget")
    log(f"[smoke] precision {tag} plan: {res.plan.split(' | ')[0]} :: "
        f"{res.plan.split(' :: ')[-1]}")
    return res, counts, peak


def mode_table(x, metric, tag):
    """The table as the mode's kernel sees it, in f32: the plain sweep's
    input at that precision (fp8 at the table's scale)."""
    from repro_torch.kernels.fused_sw import ref as fref
    from repro_torch.pipeline.registry import precision_tuning
    mode, scale = fref.resolve_precision(x, metric, **precision_tuning(tag))
    return fref.roundtrip(x, mode, scale).contiguous()


def phase_mode_pipeline(dev, x_np, grouping):
    """pipeline() at the EMP shape, default budgets, at each precision:
    plain labels (bf16, fp8 Bray-Curtis; packed jaccard) and the
    covariate design (the same three); each its mode's kernel only, held
    to the dense bridge on the round-tripped table (packed: to the f32
    jaccard run, bit for bit). Returns the launch counts by path."""
    import torch
    from repro_torch import pipeline
    from repro_torch.kernels.fused_sw import ops as fops
    from repro_torch.pipeline.registry import precision_tuning
    x = torch.from_numpy(x_np).to(dev)
    g_dev = torch.from_numpy(grouping).to(dev)
    cov, *_ = emp_design(dev, x_np, grouping)
    dense_budget = BRIDGE_BUDGETS["dense"]
    paths = {}
    for design in (False, True):
        kw = dict(covariates=cov) if design else {}
        kernel = "fused_sw_cols" if design else "fused_sw"
        for tag in ("bf16", "fp8", "packed"):
            metric = MODE_PATH_METRIC[tag]
            name = f"{'design ' if design else ''}{tag}"
            res, counts, peak = mode_run(dev, name, metric, x, g_dev,
                                         precision_tuning(tag), **kw)
            paths[name] = counts
            want = {c: 0 for c in counts}
            want[fops.launch_key(kernel, tag)] = (cols_plan()[1] if design
                                                  else fused_plan()[1])
            check(counts == want, f"precision {name} launches {counts} != "
                  f"{want}")
            check(res.plan.startswith(f"{metric}.fusedk.cuda[")
                  and f"feat_{tag}=1" in res.plan.split(" -> ")[0],
                  f"precision {name}: unexpected plan {res.plan!r}")
            check(peak < DEFAULT_MATRIX_BUDGET,
                  f"precision {name} peak {peak} B >= the matrix budget")
            if tag == "packed":
                base, base_counts, _ = mode_run(dev, f"{name} (f32 base)",
                                                metric, x, g_dev, None, **kw)
                want = {c: 0 for c in base_counts}
                want[kernel] = cols_plan()[1] if design else fused_plan()[1]
                check(base_counts == want,
                      f"f32 jaccard base launches {base_counts} != {want}")
                pairs = (list(zip(res.terms, base.terms)) if design
                         else [(res, base)])
                for t, u in pairs:
                    check(float(t.f_stat) == float(u.f_stat)
                          and float(t.p_value) == float(u.p_value)
                          and torch.equal(t.f_perms, u.f_perms),
                          f"precision {name}: F/p/null != the f32 jaccard "
                          f"run's ({float(t.f_stat)!r} vs "
                          f"{float(u.f_stat)!r})")
                log(f"[smoke] precision {name}: F, p and every null F equal "
                    f"the f32 jaccard run's bit for bit"
                    f"{' in every term' if design else ''}")
                del base
                if design:
                    del res
                    continue
            t0 = time.perf_counter()
            ref = pipeline.pipeline(
                mode_table(x, metric, tag), g_dev, metric=metric,
                n_perms=EMP_PERMS, seed=0, matrix_budget_bytes=dense_budget,
                device=dev, **kw)
            float(ref.f_stat)                                     # waits
            dt = time.perf_counter() - t0
            log(f"[smoke] precision {name}: the plain sweep at {tag} (dense "
                f"bridge on the round-tripped table) {dt:.3f}s plan: "
                f"{ref.plan.split(' | ')[0]}")
            if design:
                check_design_paths(f"precision {name}", res, ref,
                                   design_null_allowance(ref, DESIGN_K))
            else:
                f_k, p_k = float(res.f_stat), float(res.p_value)
                f_r, p_r = float(ref.f_stat), float(ref.p_value)
                check(abs(f_k - f_r) <= RTOL * abs(f_r) and p_k == p_r,
                      f"precision {name}: F={f_k} p={p_k} vs the plain "
                      f"sweep's F={f_r} p={p_r}")
                log(f"[smoke] precision {name}: F={f_k:.7g} vs {f_r:.7g} "
                    f"(rel {abs(f_k - f_r) / abs(f_r):.3e}), p {p_k} == "
                    f"{p_r}")
                null_within_f32(f"precision {name}", res.f_perms,
                                ref.f_perms)
            del res, ref
    return paths


def mode_bounds(kernel, tag, n, d, p, g_or_k, matches, chip) -> tuple:
    """(operations ms, bytes ms) for one call of a fused kernel in a mode
    at the EMP chunk (the whole table: each of its n (n - 1) / 2 pairs
    once): the operations as phases 10 and 13 count them (2 per (pair,
    feature) for D^2, or 3 per (pair, 32-bit word) packed: AND,
    popcount, add, at the f32 rate as for jaccard_packed; then the
    permutation phase's), and the bytes with each feature at the mode's
    element width (4 / 2 / 1 / 0.125 B), the labels or basis, inv_gs
    and the outputs read or written once."""
    words = -(-d // 32)
    pairs = n * (n - 1) / 2
    feat_ops = (3.0 * pairs * words if tag == "packed"
                else 2.0 * pairs * d)
    feat_bytes = 2 * n * (words * 4 if tag == "packed"
                          else d * MODE_BYTES[tag])
    if kernel == "fused_sw":
        ops_ = feat_ops + p * (n * (n - 1) / 2 + matches)
        nbytes = feat_bytes + 4 * (2 * p * n + g_or_k + p + n)
    else:
        ops_ = feat_ops + 2.0 * pairs * p * g_or_k
        nbytes = feat_bytes + 4 * (2 * p * n * g_or_k + p * g_or_k + n)
    return (ops_ / chip.peak_flops_f32 * 1e3,
            nbytes / chip.hbm_bandwidth * 1e3)


def phase_stream(dev):
    """The STREAM probe at STREAM_N elements: each op once through
    stream_op (launches counted), checked against its plain form bit for
    bit, then timed beside one PyTorch call of the op and its plain form.
    Returns (kernel rows, GB/s by op)."""
    import torch
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.stream import ops as sops, ref as sref
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.rand(STREAM_N, device=dev, generator=gen)
    b = torch.rand(STREAM_N, device=dev, generator=gen)
    s = STREAM_SCALAR
    zero_launches()
    outs = {op: sops.stream_op(a, b, s, op=op) for op in sops.OPS}
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {c: 0 for c in counts}
    want.update({f"stream.{op}": 1 for op in sops.OPS})
    check(counts == want, f"STREAM probe launches {counts} != {want}")
    out = torch.empty_like(a)
    library = {"copy": lambda: out.copy_(a),
               "scale": lambda: torch.mul(a, s, out=out),
               "add": lambda: torch.add(a, b, out=out),
               "triad": lambda: torch.add(a, b, alpha=s, out=out)}
    library_name = {"copy": "Tensor.copy_", "scale": "torch.mul(out=)",
                    "add": "torch.add(out=)",
                    "triad": "torch.add(a, b, alpha=s, out=)"}
    rows, gbps = [], {}
    for op in sops.OPS:
        plain = sref.REFS[op](a, b, s)
        equal = torch.equal(outs[op], plain)
        err = float((outs[op] - plain).abs().max())
        del plain
        outs[op] = None
        check(equal, f"stream {op} != its plain form: max abs {err:.3e}")
        # in turns (library, kernel, kernel, library, STREAM_ROUNDS
        # times), so a drift of the card's clocks weighs on both alike
        lib_t, k_t = [], []
        for _ in range(STREAM_ROUNDS):
            lib_t.append(cuda_ms(library[op], reps=10))
            k_t += [cuda_ms(lambda: sops.stream_op(a, b, s, op=op), reps=10)
                    for _ in range(2)]
            lib_t.append(cuda_ms(library[op], reps=10))
        ms, lib_ms = sum(k_t) / len(k_t), sum(lib_t) / len(lib_t)
        plain_ms = cuda_ms(lambda: sref.REFS[op](a, b, s), reps=5)
        nbytes = sops.BYTES_PER_ELEM[op] * 4 * STREAM_N
        t_bytes = nbytes / H100_SXM.hbm_bandwidth * 1e3
        t_ops = ({"copy": 0, "scale": 1, "add": 1, "triad": 2}[op]
                 * STREAM_N / H100_SXM.peak_flops_f32 * 1e3)
        gbps[op] = nbytes / ms / 1e6
        share = gbps[op] * 1e9 / H100_SXM.hbm_bandwidth * 100
        log(f"[smoke] STREAM {op:5s} n={STREAM_N}: kernel {ms:.4f} ms = "
            f"{gbps[op]:.1f} GB/s ({share:.1f}% of "
            f"{H100_SXM.hbm_bandwidth / 1e12:.2f} TB/s), library "
            f"{library_name[op]} {lib_ms:.4f} ms = "
            f"{nbytes / lib_ms / 1e6:.1f} GB/s, kernel/library "
            f"{ms / lib_ms:.4f} ({'at or below' if ms <= lib_ms else 'above'}"
            f" the library), plain {plain_ms:.4f} ms, bound {t_bytes:.4f} ms "
            f"(bytes); equal to its plain form bit for bit")
        rows.append({
            "name": f"stream.{op}", "route": "cuda", "source": STREAM_SOURCE,
            "replaces": STREAM_REPLACES, "path": "STREAM probe",
            "launches": counts[f"stream.{op}"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "library": library_name[op],
            "gb_per_s": gbps[op], "shape": {"n": STREAM_N}})
    del a, b, out, outs
    return rows, gbps


def phase_mode_timings(dev, x_np, grouping, paths, emp, gbps):
    """Each mode's kernel at its EMP chunk (the plan's) and at P = 1, the
    labels kernel also at P = ONEHOT_CHUNK, beside its plain version
    (timed in phase 14) and its bound both ways; packed beside the f32
    jaccard kernel. Returns the kernel rows."""
    import torch
    from repro_torch.core.distance import ROW_METRICS
    from repro_torch.hw import H100_SXM
    from repro_torch.kernels.fused_sw import ops as fops
    from repro_torch.pipeline.registry import precision_tuning
    x, labels, inv_gs = emp_chunk(dev, x_np, grouping)
    _, v = emp_cols_chunk(dev, x_np, grouping)
    one, one_v = labels[:1].contiguous(), v[:1].contiguous()
    l_onehot = labels[:ONEHOT_CHUNK].contiguous()
    sizes = torch.bincount(labels[0].long(), minlength=EMP_GROUPS).double()
    matches = float((sizes * (sizes - 1) / 2).sum())
    triad = gbps["triad"] * 1e9
    rows = []
    for kernel in ("fused_sw", "fused_sw_cols"):
        cols = kernel == "fused_sw_cols"
        for tag in ("f32-jaccard", "bf16", "fp8", "packed"):
            mode = "f32" if tag == "f32-jaccard" else tag
            metric = "jaccard" if mode == "f32" else MODE_PATH_METRIC[tag]
            xp = ROW_METRICS[metric].prepare(x).contiguous()
            kn = precision_tuning(mode)
            if cols:
                def call(vv, xp=xp, kn=kn, metric=metric):
                    return fops.fused_sw_rows_cols(xp, xp, vv, vv, 0,
                                                   metric=metric, **kn)
                ms = cuda_ms(lambda: call(v), reps=3)
                ms_one = cuda_ms(lambda: call(one_v), reps=5)
                p, g_or_k = cols_plan()[0], DESIGN_K
            else:
                def call(lab, xp=xp, kn=kn, metric=metric):
                    return fops.fused_sw_rows(xp, xp, lab, lab, inv_gs, 0,
                                              metric=metric, **kn)
                ms = cuda_ms(lambda: call(labels), reps=3)
                ms_one = cuda_ms(lambda: call(one), reps=5)
                ms_onehot = cuda_ms(lambda: call(l_onehot), reps=5)
                p, g_or_k = labels.shape[0], EMP_GROUPS
            ops_ms, bytes_ms = mode_bounds(kernel, mode, EMP_N, EMP_FEATURES,
                                           p, g_or_k, matches, H100_SXM)
            bytes_ms_triad = bytes_ms * H100_SXM.hbm_bandwidth / triad
            # the labels kernel runs on the CUDA cores, so its bound is
            # a floor, and so are its INT32 compares; the cols kernel's
            # product runs on the tensor cores, whose own floor is its
            # three TF32 products
            floor = max(bytes_ms, cols_own_floors_ms(x, v, H100_SXM)[1]
                        if cols else max(ops_ms, brute_floor_ms(labels)))
            check(ms > floor, f"{kernel}[{mode}] {ms:.3f} ms reads under "
                  f"its floor {floor:.3f} ms: a count is wrong")
            extra = ("" if cols else
                     f", P={ONEHOT_CHUNK} {ms_onehot:.3f} ms")
            log(f"[smoke] timing {kernel}[{mode}] {metric} (n={EMP_N}, "
                f"d={EMP_FEATURES}, P={p}, {'K' if cols else 'G'}={g_or_k}): "
                f"kernel {ms:.3f} ms, P=1 {ms_one:.3f} ms{extra}; bound by "
                f"operations {ops_ms:.3f} ms, by bytes {bytes_ms:.4f} ms at "
                f"3.35 TB/s ({bytes_ms_triad:.4f} ms at the measured triad "
                f"{gbps['triad']:.1f} GB/s); the kernel at "
                f"{max(ops_ms, bytes_ms) / ms * 100:.1f}% of the bound")
            if mode == "f32":
                continue
            key = fops.launch_key(kernel, mode)
            path = f"{'design ' if cols else ''}{mode}"
            e = emp[(kernel, mode, metric)]
            b_ms = max(ops_ms, bytes_ms)
            rows.append({
                "name": key, "route": "cuda", "source": FUSED_SOURCE,
                "replaces": COLS_REPLACES if cols else FUSED_REPLACES,
                "path": f"pipeline fused-kernel {path}",
                "launches": paths[path][key],
                "launches_by_path": {k: c[key] for k, c in paths.items()},
                "max_abs_err": e["max_abs_err"], "ms": ms,
                "plain_ms": e["plain_ms"], "bound_ms": b_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None,
                "library": "none: no PyTorch call computes features -> "
                           + ("per-column forms" if cols else "s_W"),
                "mode": mode, "metric": metric,
                "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
                "bound_bytes_ms_at_measured_triad": bytes_ms_triad,
                "ms_one_perm": ms_one,
                **({} if cols else {f"ms_p{ONEHOT_CHUNK}": ms_onehot}),
                "shape": ({"n": EMP_N, "d": EMP_FEATURES, "P": p, "K": g_or_k}
                          if cols else {"n": EMP_N, "d": EMP_FEATURES,
                                        "P": p, "G": g_or_k}),
                **{k: val for k, val in e.items()
                   if k not in ("max_abs_err", "plain_ms")}})
    return rows


# ---------------------------------------------------------------------------
# Phase 17: the fused-kernel bridge against its memory budget.
# ---------------------------------------------------------------------------

def bridge_peak_run(dev, x, g_dev, tag, **kw):
    """pipeline() with the default budgets (and kw), its launches counted
    from 0 and its device peak above the start; fails if the peak, less
    the feature table and its quantized copy, exceeds the label budget
    that sized the chunk. Returns (result, launches, seconds)."""
    import torch
    from repro_torch import pipeline
    from repro_torch.engine import planner as eplanner
    n, d = x.shape
    zero_launches()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pipeline.pipeline(x, g_dev, metric="braycurtis", seed=0,
                            device=dev, **kw)
    f_k, p_k = float(res.f_stat), float(res.p_value)              # waits
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    launches = {k: v for k, v in launch_counts().items() if v}
    budget = eplanner.DEFAULT_STREAM_BUDGET_BYTES
    copies = feature_copies(x, "braycurtis")   # f32: none
    ran = res.plan.rsplit(" :: ", 1)[1]
    log(f"[smoke] budget {tag} n={n} perms={kw['n_perms']}: {dt:.3f}s end "
        f"to end F={f_k:.7g} p={p_k:.6g} launches={launches} ({ran}); "
        f"peak above the start {peak / 2**20:.2f} MiB, less the feature "
        f"copies ({copies} B) {(peak - copies) / 2**20:.2f} MiB of the "
        f"{budget / 2**20:.0f} MiB budget")
    check(peak - copies <= budget,
          f"budget {tag}: peak {peak} B less the feature copies {copies} B "
          f"exceeds the {budget} B budget")
    check(bool(torch.isfinite(res.f_perms).all()),
          f"budget {tag}: non-finite F")
    return res, launches, dt


def sweeps_at_two_chunks(dev, x, g_dev, cov):
    """s_W, s_cols and s_T through the megakernel sweeps at the chunks of
    two budgets (256 MiB and 48 MiB, 1,000 slots): bit-equal."""
    import torch
    from repro_torch.core import design, distance, permutations
    from repro_torch.pipeline import planner, streaming
    xp = distance.ROW_METRICS["braycurtis"].prepare(x).contiguous()
    inv = permutations.inv_group_sizes(g_dev, EMP_GROUPS)
    des = design.build(grouping=g_dev.cpu().numpy(), covariates=cov,
                       n_groups=EMP_GROUPS, device=dev)
    n_total = CROSS_PERMS + 1
    out = []
    for budget in (None, 48 * 2 ** 20):
        plans = [planner.plan_pipeline(
            EMP_N, EMP_FEATURES, n_total, EMP_GROUPS, backend="cuda",
            memory_budget_bytes=budget, design_cols=k) for k in (None,
                                                                 DESIGN_K)]
        sw, st, sts = streaming.fused_sw_megakernel(
            xp, g_dev, inv, n_total, kernel_metric="braycurtis",
            chunk=plans[0].sw.chunk, seed=0, draw_budget=plans[0].draw_budget)
        sc, stc, stc_s = streaming.fused_sw_megakernel_design(
            xp, des, n_total, kernel_metric="braycurtis",
            chunk=plans[1].sw.chunk, seed=0, draw_budget=plans[1].draw_budget)
        torch.cuda.synchronize()
        out.append((sw, st, sc, stc, sts.n_chunks, stc_s.n_chunks))
    (a, b) = out
    check(a[4] != b[4] and a[5] != b[5],
          f"the two budgets must give different chunks: {a[4:]} {b[4:]}")
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
          and torch.equal(a[2], b[2]) and torch.equal(a[3], b[3]),
          "s_W / s_T / s_cols differ between two chunkings")
    log(f"[smoke] budget chunk invariance: s_W, s_T (labels; {a[4]} / "
        f"{b[4]} launches) and s_cols, s_T (K = {DESIGN_K}; {a[5]} / {b[5]} "
        f"launches) bit-equal at the 256 MiB and 48 MiB budgets' chunks")


def phase_budget(dev, x_np, grouping):
    """The fused-kernel bridge's peak against its budget: labels, strata
    only and the K = 10 design at the EMP shape (3,999 permutations) and
    labels at n = 60,000 (999), each with its chunk, launches and time;
    then the sweeps at two budgets' chunks, bit-equal."""
    import torch
    from repro_torch.data.microbiome import synthetic_study
    x = torch.from_numpy(x_np).to(dev)
    g_dev = torch.from_numpy(grouping).to(dev)
    cov, strata, _, _ = emp_design(dev, x_np, grouping)
    runs = {"labels": {}, "strata": dict(strata=strata),
            "design K=10": dict(covariates=cov)}
    for tag, kw in runs.items():
        _, launches, _ = bridge_peak_run(dev, x, g_dev, tag,
                                         n_perms=EMP_PERMS, **kw)
        want = ({"fused_sw_cols": cols_plan()[1]} if "design" in tag
                else {"fused_sw": (strata_plan() if tag == "strata"
                                   else fused_plan())[1]})
        check(launches == want, f"budget {tag}: launches {launches} != "
              f"{want}")
    del x, g_dev
    x6, g6 = synthetic_study(BUDGET_N, EMP_FEATURES, EMP_GROUPS,
                             effect_size=1.0, seed=0)
    x6, g6 = torch.from_numpy(x6).to(dev), torch.from_numpy(g6).to(dev)
    res, launches, _ = bridge_peak_run(dev, x6, g6, "labels",
                                       n_perms=CROSS_PERMS)
    log(f"[smoke] budget labels n={BUDGET_N} plan: {res.plan}")
    check(set(launches) == {"fused_sw"}, f"n={BUDGET_N}: {launches}")
    del x6, g6, res
    sweeps_at_two_chunks(dev, torch.from_numpy(x_np).to(dev),
                         torch.from_numpy(grouping).to(dev), cov)


# ---------------------------------------------------------------------------
# Phase 18: many-study runs.
# ---------------------------------------------------------------------------

def many_peak(fn):
    """(result, seconds, device peak above the start) of fn()."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    res.f_stat.sum().item()                                        # waits
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - start)


def check_study_equal(tag, many, s, one):
    """Study s of a many-study result against its single-study run: F
    null and p bit for bit (and every design term's)."""
    import torch
    same = (torch.equal(many.f_perms[s], one.f_perms)
            and float(many.p_value[s]) == float(one.p_value))
    if one.terms is not None:
        same = same and all(torch.equal(tm.f_perms[s], to.f_perms)
                            for tm, to in zip(many.terms, one.terms))
    check(same, f"many {tag}: study {s} != its single-study run "
          f"(F {float(many.f_stat[s])!r} vs {float(one.f_stat)!r})")


def phase_many(dev):
    """pipeline_many on 3 stacked EMP-shape studies (labels, and the K =
    10 covariate design), each study bit-equal to pipeline(x_s,
    seed=study_seed(0, s)) and the batch's peak within the budget; then
    permanova_many on a ragged batch of 6 studies (n = 1,500 ... 9,000,
    n_pad = 10,240 recorded) through brute, each study bit-equal to its
    engine.run (by construction: a ragged study runs on its own
    matrix)."""
    import numpy as np
    import torch
    from repro_torch import engine, pipeline
    from repro_torch.core import distance
    from repro_torch.core.permutations import study_seed
    from repro_torch.data.microbiome import synthetic_design, synthetic_study
    from repro_torch.engine import planner as eplanner
    from repro_torch.kernels.distance import ops as dops
    studies = [synthetic_study(EMP_N, EMP_FEATURES, EMP_GROUPS,
                               effect_size=1.0, seed=s)
               for s in range(MANY_STUDIES)]
    xs = torch.from_numpy(np.stack([x for x, _ in studies])).to(dev)
    gs = torch.from_numpy(np.stack([g for _, g in studies])).to(dev)
    covs = [synthetic_design(EMP_N, covariate_names=DESIGN_COVARIATES,
                             seed=s)[0] for s in range(MANY_STUDIES)]
    cov_stack = np.stack([np.stack([c[k] for k in DESIGN_COVARIATES], 1)
                          for c in covs])
    budget = eplanner.DEFAULT_STREAM_BUDGET_BYTES
    copies = feature_copies(xs[0], "braycurtis")    # f32: none
    for tag, kw in (("labels", {}), ("covariates", dict(
            covariates=cov_stack))):
        zero_launches()
        res, dt, peak = many_peak(lambda: pipeline.pipeline_many(
            xs, gs, n_groups=EMP_GROUPS, n_perms=EMP_PERMS, seed=0,
            device=dev, **kw))
        launches = {k: v for k, v in launch_counts().items() if v}
        log(f"[smoke] many pipeline_many {tag} S={MANY_STUDIES} "
            f"n={EMP_N} perms={EMP_PERMS}: {dt:.3f}s end to end, "
            f"{dt / MANY_STUDIES:.3f}s a study; F={res.f_stat.tolist()} "
            f"p={res.p_value.tolist()} launches={launches}; peak above "
            f"the start {peak / 2**20:.2f} MiB ({(peak - copies) / 2**20:.2f}"
            f" less a study's feature copies)")
        log(f"[smoke] many pipeline_many {tag} plan: {res.plan}")
        kernel, per = (("fused_sw_cols", cols_plan()[1]) if kw
                       else ("fused_sw", fused_plan()[1]))
        check("fused-kernel(rows=" in res.plan
              and launches == {kernel: per * MANY_STUDIES},
              f"many {tag}: auto must run the fused-kernel bridge, "
              f"{per} {kernel} launches a study: {launches}")
        check(peak - copies <= budget,
              f"many {tag}: a study's peak exceeds the budget: {peak} B")
        for s in range(MANY_STUDIES):
            one = pipeline.pipeline(
                xs[s], gs[s], n_perms=EMP_PERMS, seed=study_seed(0, s),
                device=dev, **({} if not kw else dict(
                    covariates=covs[s])))
            check_study_equal(f"pipeline_many {tag}", res, s, one)
        log(f"[smoke] many pipeline_many {tag}: each study's F null and p "
            "== pipeline(x_s, seed=study_seed(0, s)) bit for bit")
    del xs, gs
    dms, groupings = [], []
    for i, n in enumerate(RAGGED_SIZES):
        x, g = synthetic_study(n, EMP_FEATURES, EMP_GROUPS, effect_size=0.3,
                               seed=100 + i)
        xt = distance.ROW_METRICS["braycurtis"].prepare(
            torch.from_numpy(x).to(dev)).contiguous()
        dms.append(dops.pairwise_distance(xt, metric="braycurtis"))
        groupings.append(torch.from_numpy(g).to(dev))
    zero_launches()
    res, dt, peak = many_peak(lambda: engine.permanova_many(
        dms, groupings, n_groups=EMP_GROUPS, n_perms=EMP_PERMS, seed=0,
        n_pad=RAGGED_PAD, device=dev))
    launches = {k: v for k, v in launch_counts().items() if v}
    log(f"[smoke] many permanova_many ragged S={len(RAGGED_SIZES)} "
        f"n={list(RAGGED_SIZES)} n_pad={RAGGED_PAD} perms={EMP_PERMS}: "
        f"{dt:.3f}s, launches={launches}, F={res.f_stat.tolist()}, "
        f"p={res.p_value.tolist()}; plan: {res.plan}")
    check(set(launches) == {"brute"} and res.n_objects == RAGGED_PAD
          and res.n_valid.tolist() == list(RAGGED_SIZES),
          f"many ragged: brute only at n_pad: {launches}")
    zero_launches()
    t0 = time.perf_counter()
    for s in range(len(RAGGED_SIZES)):
        one = engine.run(dms[s], groupings[s], n_perms=EMP_PERMS,
                         seed=study_seed(0, s), device=dev)
        check_study_equal("permanova_many ragged", res, s, one)
    log(f"[smoke] many ragged: each study's F null and p == its "
        f"engine.run bit for bit ({time.perf_counter() - t0:.3f}s "
        f"for the {len(RAGGED_SIZES)} runs, launches "
        f"{ {k: v for k, v in launch_counts().items() if v} })")


AUTOTUNE_CANDIDATES = ("brute", "matmul", "tiled")
PCOA_K = 3
PCOA_CHECK_N = 8192
PCOA_RTOL = 2e-4        # the reference's bar (tests/test_ordination.py:40)
PCOA_BRIDGE_RTOL = 2e-3     # its bridges' agreement (:119)


def phase_autotune(dev, x_np, grouping, f_p_main, cache_dir):
    """engine.run(autotune=True) and pipeline(autotune=True) at the EMP
    shape against phase 3's heuristic run, the winner persisted in the
    run's own cache file and read back without a measurement."""
    import torch
    from repro_torch import engine, pipeline
    from repro_torch.core.distance import distance_matrix
    from repro_torch.engine import planner
    path = os.environ[planner.AUTOTUNE_CACHE_ENV]
    check(os.path.dirname(path) == cache_dir and not os.path.exists(path),
          f"autotune cache {path} must be a new file in {cache_dir}")
    f0, p0 = f_p_main
    x = torch.from_numpy(x_np).to(dev)
    g_dev = torch.from_numpy(grouping).to(dev)
    dm = distance_matrix(x, "braycurtis")
    before = dict(planner.MEASURED)
    zero_launches()
    t0 = time.perf_counter()
    res = engine.run(dm, g_dev, n_perms=EMP_PERMS, seed=0, autotune=True,
                     device=dev)
    f_t, p_t = float(res.f_stat), float(res.p_value)              # waits
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    key = planner._persist_key(planner.device_kind("cuda"), EMP_N,
                               EMP_GROUPS)
    entry = planner.measured_entry(key)
    check(entry is not None and entry["candidates"] == list(
        AUTOTUNE_CANDIDATES) and set(entry["times_ms"]) == set(
        AUTOTUNE_CANDIDATES), f"autotune entry {key}: {entry}")
    times = entry["times_ms"]
    winner = entry["impl"]
    log(f"[smoke] autotune key {key}: candidates (median of "
        f"{entry['calls']} calls at P={entry['sample_perms']}, ms) "
        + ", ".join(f"{c} ({KERNEL_OF[c]} kernel) {times[c]:.3f}"
                    for c in AUTOTUNE_CANDIDATES)
        + f"; winner {winner}")
    log(f"[smoke] autotune engine.run {dt:.3f}s (shoot-out included) "
        f"F={f_t:.7g} p={p_t:.6g} launches={launches} plan: {res.plan}")
    check(planner.MEASURED["sw"] == before.get("sw", 0) + 1,
          "autotune must run one shoot-out")
    check("empirical autotune winner" in res.plan
          and res.plan.startswith(f"{winner}["),
          f"the tuned run must run its winner: {res.plan!r}")
    chunks = int(res.plan.rsplit("chunks=", 1)[1])
    shoot = 1 + planner.TIMED_CALLS
    want = {KERNEL_OF[c]: shoot + (chunks if c == winner else 0)
            for c in AUTOTUNE_CANDIDATES}
    check(launches == want, f"autotune launches {launches} != {want} "
          f"({shoot} a candidate, {chunks} chunks of the winner)")
    check(abs(f_t - f0) <= RTOL * abs(f0) and p_t == p0,
          f"autotuned F={f_t} p={p_t} vs phase 3's F={f0} p={p0}")
    # the shoot-out's pick against the run it stands for: the EMP test
    # pinned to each compare-and-add impl, in turns (best of 2)
    e2e = {c: [] for c in ("brute", "tiled")}
    for c in ("brute", "tiled", "tiled", "brute"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(engine.run(dm, g_dev, n_perms=EMP_PERMS, seed=0, impl=c,
                         device=dev).f_stat)
        e2e[c].append(time.perf_counter() - t0)
    log("[smoke] autotune in turns, engine.run pinned (best of 2, s): "
        + ", ".join(f"{c} {min(t):.4f}" for c, t in e2e.items())
        + f"; the shoot-out picked {winner}")
    planner.load_autotune_cache(reload=True)     # a new process's view
    t0 = time.perf_counter()
    again = engine.run(dm, g_dev, n_perms=EMP_PERMS, seed=0, autotune=True,
                       device=dev)
    float(again.f_stat)
    dt2 = time.perf_counter() - t0
    check(planner.MEASURED["sw"] == before.get("sw", 0) + 1,
          "the second tuned call must measure nothing")
    check(torch.equal(again.f_perms, res.f_perms),
          "the second tuned call must run the same winner")
    pl = planner.plan(EMP_N, EMP_PERMS + 1, backend="cuda",
                      n_groups=EMP_GROUPS)
    check(pl.impl == winner and pl.reason.startswith(
        "persisted autotune measurement"), f"plain plan: {pl.describe()}")
    log(f"[smoke] autotune second call {dt2:.3f}s: read the persisted "
        f"entry, measured nothing (sw shoot-outs this run: "
        f"{planner.MEASURED['sw'] - before.get('sw', 0)}); plan() without "
        f"autotune: {pl.describe()}")
    del dm, res, again
    zero_launches()
    t0 = time.perf_counter()
    res = pipeline.pipeline(x, g_dev, n_perms=EMP_PERMS, seed=0,
                            matrix_budget_bytes=BRIDGE_BUDGETS["dense"],
                            autotune=True, device=dev)
    f_d, p_d = float(res.f_stat), float(res.p_value)
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    stage1 = planner.measured_entry("dist|" + planner.device_kind("cuda")
                                    + "|braycurtis|braycurtis.cuda")
    log(f"[smoke] autotune pipeline dense {dt:.3f}s F={f_d:.7g} "
        f"p={p_d:.6g} launches={launches}; stage 1 braycurtis.cuda "
        f"{stage1['ms']:.3f} ms (median of {planner.TIMED_CALLS}); plan: "
        f"{res.plan}")
    check(planner.MEASURED["stage1"] == before.get("stage1", 0) + 1
          and planner.MEASURED["sw"] == before.get("sw", 0) + 1,
          f"pipeline autotune: one stage-1 shoot-out, no s_W one: "
          f"{dict(planner.MEASURED)}")
    check(res.plan.startswith("braycurtis.cuda[] -> dense(")
          and "empirical autotune winner" in res.plan,
          f"pipeline autotune plan: {res.plan!r}")
    check(launches.get("braycurtis") == 1 + shoot,
          f"stage 1: {shoot} shoot-out launches and the bridge's one: "
          f"{launches}")
    check(abs(f_d - f0) <= RTOL * abs(f0) and p_d == p0,
          f"pipeline autotune F={f_d} p={p_d} vs phase 3's F={f0} p={p0}")
    # later runs of this script plan from the heuristics again
    os.environ[planner.AUTOTUNE_CACHE_ENV] = os.path.join(cache_dir,
                                                          "empty.json")
    check(planner.plan(EMP_N, EMP_PERMS + 1, backend="cuda",
                       n_groups=EMP_GROUPS).impl == "brute",
          "the empty cache must plan brute")


def pcoa_aligned_err(res, wk, coords_ref) -> tuple:
    """(eigenvalue error, sign-aligned coordinate error), each over the
    reference's scale as the reference's test bars them."""
    import torch
    ev = res.eigvals.double()
    c = res.coords.double()
    sgn = torch.sign((c * coords_ref).sum(0))
    sgn[sgn == 0] = 1.0
    e_ev = float(((ev - wk).abs() / (wk.abs() + wk.abs().max())).max())
    e_c = float(((c * sgn - coords_ref).abs()
                 / (coords_ref.abs() + coords_ref.abs().max())).max())
    return e_ev, e_c


def pcoa_check(tag, res, wk, coords_ref, s_t, rtol):
    """res against (eigenvalues, coordinates, s_T) at the reference's
    assert_allclose(rtol, atol=rtol * max) bars, explained == eigvals /
    s_T."""
    import torch
    ev = res.eigvals.double()
    c = res.coords.double()
    sgn = torch.sign((c * coords_ref).sum(0))
    sgn[sgn == 0] = 1.0
    ok_ev = bool(((ev - wk).abs() <= rtol * wk.abs()
                  + rtol * wk.abs().max()).all())
    ok_c = bool(((c * sgn - coords_ref).abs() <= rtol * coords_ref.abs()
                 + rtol * coords_ref.abs().max()).all())
    ok_x = bool(((res.explained.double() - wk / s_t).abs()
                 <= 1e-3 * (wk / s_t).abs() + 1e-5).all())
    e_ev, e_c = pcoa_aligned_err(res, wk, coords_ref)
    log(f"[smoke] pcoa {tag}: eigenvalues {[round(float(v), 4) for v in ev]}"
        f", max err {e_ev:.3e} / coords {e_c:.3e} of scale, iterations "
        f"{res.iterations}")
    check(ok_ev and ok_c and ok_x,
          f"pcoa {tag}: outside rtol {rtol} (eigenvalues {ok_ev}, coords "
          f"{ok_c}, explained {ok_x})")


def phase_ordination(dev, x_np, grouping):
    """pipeline(ordination=3) at the EMP shape on the fused-kernel and the
    stream bridges; at n = 8,192 the subspace paths against eigh and a
    float64 oracle."""
    import torch
    from repro_torch import pipeline
    from repro_torch.data.microbiome import synthetic_study
    from repro_torch.pipeline import ordination as ordn
    from repro_torch.pipeline import planner as pplanner
    from repro_torch.pipeline import registry
    x = torch.from_numpy(x_np).to(dev)
    g_dev = torch.from_numpy(grouping).to(dev)
    rows = pplanner.plan_pipeline(
        EMP_N, EMP_FEATURES, EMP_PERMS + 1, EMP_GROUPS, backend="cuda",
        metric="braycurtis").row_block
    n_slabs = -(-EMP_N // rows)
    out = {}
    for bridge, kw in (("fused-kernel", {}), ("stream", dict(
            matrix_budget_bytes=BRIDGE_BUDGETS["stream"]))):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipeline.pipeline(x, g_dev, n_perms=EMP_PERMS, seed=0,
                                ordination=PCOA_K, device=dev, **kw)
        o = res.ordination
        o.coords.sum().item()                                      # waits
        dt = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        its = o.iterations
        # the marginals' sweep, 16 radius matvecs, the start, the
        # iterations and the Rayleigh-Ritz product: one slab sweep each
        sweeps = 1 + ordn.RADIUS_ITERS + 1 + its + 1
        want = ({"fused_sw": fused_plan()[1], "braycurtis": sweeps * n_slabs}
                if bridge == "fused-kernel" else
                {"braycurtis": -(-EMP_N // STREAM_ROWS), "brute": 2})
        log(f"[smoke] pcoa {bridge} n={EMP_N} k={PCOA_K}: {dt:.3f}s end to "
            f"end (test + ordination), method {o.method}, {its} "
            f"iterations, eigenvalues {[round(float(v), 4) for v in o.eigvals]}"
            f", explained {[round(float(v), 5) for v in o.explained]}, "
            f"launches={launches}")
        check(launches == want, f"pcoa {bridge}: launches {launches} != "
              f"{want}")
        check(o.coords.shape == (EMP_N, PCOA_K)
              and bool(torch.isfinite(o.coords).all())
              and bool((o.eigvals[:-1] >= o.eigvals[1:]).all()),
              f"pcoa {bridge}: coordinates must be finite (n, k), "
              "eigenvalues descending")
        check(bool(torch.allclose(o.explained * res.s_t, o.eigvals,
                                  rtol=1e-4)),
              f"pcoa {bridge}: explained * s_T != eigenvalues")
        out[bridge] = o
        del res
    # the ordination alone on the fused bridges' path, timed
    prepare, rows_fn, _ = registry.get("braycurtis.cuda").bound()
    xp = prepare(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alone = ordn.pcoa_features(xp, rows_fn, PCOA_K, row_block=rows)
    alone.coords.sum().item()
    t_alone = time.perf_counter() - t0
    log(f"[smoke] pcoa_features alone n={EMP_N}: {t_alone:.3f}s, "
        f"{alone.iterations} iterations, {n_slabs} slabs of {rows} rows a "
        f"matvec ({t_alone / (alone.iterations + 19) * 1e3:.2f} ms a "
        f"matvec)")
    a, b = out["fused-kernel"], out["stream"]
    e_ev, e_c = pcoa_aligned_err(a, b.eigvals.double(), b.coords.double())
    log(f"[smoke] pcoa fused-kernel vs stream at n={EMP_N}: eigenvalues "
        f"{e_ev:.3e}, coords {e_c:.3e} of scale")
    pcoa_check("fused-kernel vs stream (EMP)", a, b.eigvals.double(),
               b.coords.double(), float(b.eigvals[0] / b.explained[0]),
               PCOA_BRIDGE_RTOL)
    del out, a, b, alone, xp

    xs, _ = synthetic_study(PCOA_CHECK_N, EMP_FEATURES, EMP_GROUPS,
                            effect_size=1.0, seed=1)
    xs = prepare(torch.from_numpy(xs).to(dev))
    from repro_torch.kernels.distance import ops as dops
    dm = dops.pairwise_distance(xs, metric="braycurtis")
    mat2 = dm * dm
    del dm
    t0 = time.perf_counter()
    m = mat2.double()
    rs = m.sum(1)
    n = PCOA_CHECK_N
    g64 = -0.5 * (m - rs[:, None] / n - rs[None, :] / n + rs.sum() / n / n)
    del m
    w, v = torch.linalg.eigh(g64)
    s_t = float(torch.trace(g64))
    del g64
    order = torch.argsort(-w)[:PCOA_K]
    wk, vk = w[order], v[:, order]
    coords_ref = vk * wk.clamp(min=0).sqrt()[None, :]
    del v
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    timed = {}
    for tag, fn in (("eigh", lambda: ordn.pcoa_eigh(mat2, PCOA_K)),
                    ("subspace", lambda: ordn.pcoa_subspace(mat2, PCOA_K)),
                    ("features", lambda: ordn.pcoa_features(
                        xs, rows_fn, PCOA_K, row_block=rows))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        r.coords.sum().item()
        timed[tag] = (time.perf_counter() - t0, r)
    log(f"[smoke] pcoa n={n}: float64 eigh oracle {t64:.3f}s; "
        + ", ".join(f"{t} {dt:.3f}s" for t, (dt, _) in timed.items()))
    for tag, (_, r) in timed.items():
        pcoa_check(f"{tag} vs float64 (n={n})", r, wk, coords_ref, s_t,
                   PCOA_RTOL)
    e = timed["eigh"][1]
    for tag in ("subspace", "features"):
        pcoa_check(f"{tag} vs eigh (n={n})", timed[tag][1],
                   e.eigvals.double(), e.coords.double(), s_t, PCOA_RTOL)


# phase 21: out of core. The realistic cell: the paper's EMP sample count
# at a filtered sOTU table's width, dense f32 on disk in 13 slabs (12 x
# 2,048 + 569), a device budget under the table, so the residency is
# 'host'
OOC_N, OOC_D, OOC_SLAB, OOC_DENSITY = 25145, 16384, 2048, 0.1
OOC_TABLE_BYTES = 1_647_902_720         # 4 n d
OOC_SLABS = 13
OOC_READ_BYTES = 23_070_638_080         # 14 passes: (13 + 1) x the table
OOC_BUDGET = 1536 * 2 ** 20              # 1.5 GiB, under the 1.535 GiB table
OOC_DESIGN_PERMS = 999
OOC_AITCHISON_PERMS = 999
OOC_IDLE_PERMS = 999        # the labels sweep profiled for phase 22
# (a) at small sizes: the tile-assembled row slabs (n, d, slab_rows) with a
# ragged last slab of 196, and pipeline() at the cell's width: at d = 512
# the sweep's own footprint (the feature slabs in flight and the (256, n)
# mat2 row slab) exceeds the table, so no device budget would both force
# 'host' and hold the sweep (the plan refuses it)
OOC_SMALL = (2500, 512, 256)
OOC_SMALL_PIPE_D = 16384
OOC_SMALL_PERMS = 99
OOC_SMALL_LABEL_BUDGET = 4 * 2 ** 20
OOC_METRICS = ("braycurtis", "euclidean", "aitchison", "jaccard")
H2D_BYTES = OOC_SLAB * OOC_D * 4        # one 128 MiB slab
H2D_REPS = 10


def ooc_identical(tag, res, ref):
    """F, p, s_T and the whole null of an out-of-core run equal to the
    in-memory run's bit for bit (per term for a design)."""
    import torch
    if ref.terms is None:
        same = all(torch.equal(getattr(res, k), getattr(ref, k))
                   for k in ("f_stat", "p_value", "s_t", "s_w", "f_perms"))
    else:
        same = ([t.name for t in res.terms] == [t.name for t in ref.terms]
                and torch.equal(res.s_t, ref.s_t)
                and all(torch.equal(a.f_perms, b.f_perms)
                        and torch.equal(a.p_value, b.p_value)
                        for a, b in zip(res.terms, ref.terms)))
    check(same, f"ooc {tag}: F, p or the null differ from the in-memory "
          f"fused bridge's")


def ooc_row_blocks_identity(dev, root):
    """(a) For every metric (jaccard f32 from a dense cache, jaccard packed
    from a csr cache), the row slabs ooc_mat2_row_blocks assembles from
    (slab, slab) distance tiles equal mat2_row_blocks' slabs of the
    resident table bit for bit, the ragged last one included; the
    distance kernel launched once a tile and once a resident slab."""
    import torch
    from repro_torch.data.microbiome import synthetic_sparse_counts
    from repro_torch.pipeline import registry, streaming
    n, d, slab = OOC_SMALL
    caches = {fmt: synthetic_sparse_counts(
        n, d, density=OOC_DENSITY, seed=1, slab_rows=slab, fmt=fmt,
        cache_dir=os.path.join(root, f"rows_{fmt}"))[0]
        for fmt in ("dense", "csr")}
    n_slabs = caches["dense"].n_slabs
    x = torch.from_numpy(caches["dense"].to_array()).to(dev)
    cases = [(m, "dense", {}) for m in OOC_METRICS] + [
        ("jaccard", "csr", {"packed": 1})]
    for metric, fmt, tuning in cases:
        prepare, rows_fn, _ = registry.get(f"{metric}.cuda").bound(**tuning)
        kernel = ("jaccard_packed" if tuning else
                  "euclidean" if metric == "aitchison" else metric)
        zero_launches()
        got = streaming.ooc_mat2_row_blocks(caches[fmt], prepare, rows_fn,
                                            device=dev)
        want = streaming.mat2_row_blocks(prepare(x), rows_fn, block=slab)
        rows = []
        for (lo_a, a), (lo_b, b) in zip(got, want):
            check(lo_a == lo_b and torch.equal(a, b),
                  f"ooc row slab at {lo_b} ({metric}, {fmt} cache "
                  f"{tuning}): the tile-assembled slab differs from "
                  f"mat2_row_blocks'")
            rows.append(a.shape[0])
        got.close()
        torch.cuda.synchronize()
        launches = launch_counts()[kernel]
        check(len(rows) == n_slabs and rows[-1] == n % slab
              and launches == n_slabs * n_slabs + n_slabs,
              f"ooc row slabs {metric}: {rows}, {launches} {kernel} "
              f"launches")
        log(f"[smoke] ooc row slabs {metric:10s} ({fmt} cache"
            f"{', packed' if tuning else ''}) (n, d, slab)={OOC_SMALL}: "
            f"{n_slabs} slabs (last {rows[-1]} rows) equal mat2_row_blocks' "
            f"bit for bit; {launches} {kernel} launches ({n_slabs}^2 tiles "
            f"+ {n_slabs} resident slabs)")


def ooc_pipeline_identity(dev, root):
    """(a) pipeline(cache) at a device budget one byte under the table
    ('host') against the in-memory fused bridge at row_block = slab_rows
    on the same table, seed and label budget, bit for bit: every metric,
    both forms, labels, labels within 4 strata, and the dense design of
    two covariates and 4 strata; jaccard f32 and packed from a csr cache
    against the presence table; the 'hbm' short circuit (the default 2 GiB
    budget) against the resident run at the default budgets."""
    import torch
    from repro_torch import pipeline
    from repro_torch.data.microbiome import (synthetic_design,
                                             synthetic_sparse_counts)
    n, _, slab = OOC_SMALL
    d = OOC_SMALL_PIPE_D
    dense, grouping = synthetic_sparse_counts(
        n, d, density=OOC_DENSITY, seed=2, slab_rows=slab,
        cache_dir=os.path.join(root, "pipe_dense"))
    csr, _ = synthetic_sparse_counts(
        n, d, density=OOC_DENSITY, seed=2, slab_rows=slab, fmt="csr",
        cache_dir=os.path.join(root, "pipe_csr"))
    x = torch.from_numpy(dense.to_array()).to(dev)
    g = torch.from_numpy(grouping).to(dev)
    cov, strata, _ = synthetic_design(n, covariate_names=DESIGN_COVARIATES,
                                      n_strata=DESIGN_STRATA, seed=2)
    modes = {"labels": {}, "strata": {"strata": strata},
             "design": {"covariates": cov, "strata": strata}}
    host = dense.feature_bytes - 1
    kw = dict(n_perms=OOC_SMALL_PERMS, seed=0, device=dev,
              memory_budget_bytes=OOC_SMALL_LABEL_BUDGET)
    t0 = time.perf_counter()
    runs = 0
    for metric in OOC_METRICS:
        for mode, mkw in modes.items():
            ref = pipeline.pipeline(x, g, metric=metric, materialize="fused",
                                    row_block=slab, **mkw, **kw)
            for form in ("fused", "fused-kernel"):
                res = pipeline.pipeline(dense, g, metric=metric,
                                        materialize=form,
                                        device_budget_bytes=host, **mkw,
                                        **kw)
                check("residency=host" in res.plan
                      and f"ooc-{form}" in res.method,
                      f"ooc {metric} {mode} {form}: {res.method} "
                      f"{res.plan}")
                ooc_identical(f"{metric} {mode} {form}", res, ref)
                runs += 1
    presence = (x > 0).to(torch.float32)
    for packed in (0, 1):
        tuning = {"packed": packed}
        ref = pipeline.pipeline(presence, g, metric="jaccard",
                                materialize="fused", row_block=slab,
                                dist_tuning=tuning, **kw)
        res = pipeline.pipeline(csr, g, metric="jaccard", dist_tuning=tuning,
                                device_budget_bytes=host, **kw)
        ooc_identical(f"jaccard csr packed={packed}", res, ref)
        runs += 1
    res = pipeline.pipeline(dense, g, **kw)
    check(res.plan.endswith("| features=slab-cache(residency=hbm)"),
          f"ooc hbm short circuit: {res.plan}")
    ooc_identical("hbm short circuit", res, pipeline.pipeline(x, g, **kw))
    log(f"[smoke] ooc pipeline (n, d, slab)=({n}, {d}, {slab}), "
        f"{OOC_SMALL_PERMS} permutations, label budget "
        f"{OOC_SMALL_LABEL_BUDGET // 2 ** 20} MiB, device budget {host} B: "
        f"{runs} out-of-core runs (4 metrics x labels / strata / design x "
        f"fused / fused-kernel, csr jaccard f32 / packed) and the hbm short "
        f"circuit equal the in-memory runs bit for bit "
        f"({time.perf_counter() - t0:.2f}s)")


def h2d_rates(dev) -> dict:
    """GB/s of host -> device copies of one 128 MiB slab from pinned and
    from pageable memory, by CUDA events over H2D_REPS copies."""
    import torch
    n = H2D_BYTES // 4
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    rates = {}
    for tag, pinned in (("pinned", True), ("pageable", False)):
        src = torch.ones(n, dtype=torch.float32, pin_memory=pinned)
        ms = cuda_ms(lambda: dst.copy_(src, non_blocking=pinned), H2D_REPS)
        rates[tag] = H2D_BYTES / (ms * 1e-3) / 1e9
    return rates


def ooc_run(dev, cache, g_dev, tag, pl, **kw):
    """One out-of-core pipeline() run of the realistic cell at OOC_BUDGET:
    its launches counted from 0, its device peak above the start (the
    allocated bytes, and the allocator's reserved ones from an emptied
    cache), the sweep's OocStats (the result's). Fails unless the plan is
    `pl`, the metric's distance kernel launched once a tile and nothing
    else ran, the bytes read equal the traffic model's, and the peak
    (allocated, and reserved: slabs freed while a kernel still reads
    them stay reserved, and the prefetcher's stream keeps its own pool)
    stays within the plan's modelled peak, itself within the budget."""
    import torch
    from repro_torch import pipeline
    kernel = "euclidean" if pl.metric == "aitchison" else pl.metric
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    start_r = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pipeline.pipeline(cache, g_dev, metric=pl.metric, seed=0,
                            device_budget_bytes=OOC_BUDGET, device=dev, **kw)
    f, p = float(res.f_stat), float(res.p_value)                  # waits
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    peak_r = torch.cuda.max_memory_reserved() - start_r
    st = res.ooc_stats
    launches = {k: v for k, v in launch_counts().items() if v}
    footprint = pl.ooc_peak
    log(f"[smoke] ooc {tag}: {dt:.3f}s end to end, sweep {st.sweep_s:.3f}s, "
        f"stall {st.stall_s:.3f}s; F={f:.7g} p={p:.6g}; read "
        f"{st.disk_bytes_read} B in {st.n_slabs} x {st.n_slabs + 1} fetches; "
        f"{st.n_chunks} chunks of {st.chunk} a row slab; launches "
        f"{launches}; peak above the start {peak / 2 ** 20:.2f} MiB "
        f"allocated, {peak_r / 2 ** 20:.2f} MiB reserved, of the plan's "
        f"modelled peak {footprint / 2 ** 20:.2f} MiB ("
        + ", ".join(f"{k} {v / 2 ** 20:.2f}"
                    for k, v in pl.ooc_footprint.items())
        + f") in the {OOC_BUDGET / 2 ** 20:.0f} MiB device budget; "
        f"{card_line()}")
    check(res.plan.startswith(pl.describe()),
          f"ooc {tag}: the run's plan is not the planner's: {res.plan}")
    check(launches == {kernel: OOC_SLABS * OOC_SLABS},
          f"ooc {tag}: launches {launches}, expected "
          f"{OOC_SLABS * OOC_SLABS} {kernel}")
    check(st.disk_bytes_read == OOC_READ_BYTES,
          f"ooc {tag}: read {st.disk_bytes_read} B, the traffic model "
          f"{OOC_READ_BYTES} B")
    check(footprint <= OOC_BUDGET and max(peak, peak_r) <= footprint,
          f"ooc {tag}: peak {peak} B allocated, {peak_r} B reserved, "
          f"modelled peak {footprint} B, budget {OOC_BUDGET} B")
    check(bool(torch.isfinite(res.f_perms).all()), f"ooc {tag}: non-finite")
    return res, dt


def ooc_emp(dev, root):
    """(b) The realistic cell on one card: the EMP-width cache built by
    synthetic_sparse_counts, Bray-Curtis labels at 3,999 permutations,
    the covariate design (K = 10) at 999 and Aitchison labels at 999 (clr
    in place on each fetched slab) out of core, each against
    the same table resident on the card through the in-memory fused
    bridge at row_block = 2,048, bit for bit."""
    import torch
    from repro_torch import pipeline
    from repro_torch.core import design as design_mod
    from repro_torch.data.microbiome import (synthetic_design,
                                             synthetic_sparse_counts)
    from repro_torch.pipeline import planner, registry
    t0 = time.perf_counter()
    cache, grouping = synthetic_sparse_counts(
        OOC_N, OOC_D, density=OOC_DENSITY, seed=0, slab_rows=OOC_SLAB,
        cache_dir=os.path.join(root, "emp"))
    build_s = time.perf_counter() - t0
    check(cache.disk_bytes == OOC_TABLE_BYTES and cache.n_slabs == OOC_SLABS
          and cache.rows_in_slab(OOC_SLABS - 1) == OOC_N % OOC_SLAB
          and registry.ooc_disk_traffic_bytes(cache.n_slabs,
                                              cache.disk_bytes)
          == OOC_READ_BYTES,
          f"ooc cache: {cache.disk_bytes} B in {cache.n_slabs} slabs")
    g = torch.from_numpy(grouping).to(dev)
    cov, _, _ = synthetic_design(OOC_N, covariate_names=DESIGN_COVARIATES,
                                 seed=0)
    des = design_mod.build(grouping=g, covariates=cov, n_groups=EMP_GROUPS,
                           device=dev)
    check(des.k_cols == DESIGN_K, f"ooc design K = {des.k_cols}")
    log(f"[smoke] ooc cache ({OOC_N}, {OOC_D}) density {OOC_DENSITY}: "
        f"{cache.disk_bytes} B dense f32 in {cache.n_slabs} slabs of "
        f"{OOC_SLAB} (last {cache.rows_in_slab(OOC_SLABS - 1)}), built in "
        f"{build_s:.2f}s")
    rates = h2d_rates(dev)
    log(f"[smoke] ooc host -> device, one {H2D_BYTES // 2 ** 20} MiB slab "
        f"(CUDA events, {H2D_REPS} copies): pinned {rates['pinned']:.2f} "
        f"GB/s, pageable {rates['pageable']:.2f} GB/s (the host tier's "
        f"model: {registry.tier_bandwidth_gbps('host', 'cuda'):.2f} GB/s); "
        f"{card_line()}")

    def plan(n_total, n_groups, k=None, metric="braycurtis"):
        return planner.plan_pipeline(
            OOC_N, OOC_D, n_total, n_groups, backend="cuda",
            metric=metric, design_cols=k, features_on_disk=True,
            slab_rows=OOC_SLAB, features_disk_bytes=cache.disk_bytes,
            device_budget_bytes=OOC_BUDGET)
    runs = [("labels", dict(n_perms=EMP_PERMS),
             plan(EMP_PERMS + 1, EMP_GROUPS)),
            ("covariates", dict(n_perms=OOC_DESIGN_PERMS, covariates=cov,
                                n_groups=EMP_GROUPS),
             plan(OOC_DESIGN_PERMS + 1, des.n_groups or des.rank,
                  des.k_cols)),
            ("aitchison", dict(n_perms=OOC_AITCHISON_PERMS),
             plan(OOC_AITCHISON_PERMS + 1, EMP_GROUPS,
                  metric="aitchison"))]
    for _, _, pl in runs:
        check(pl.residency == "host" and pl.row_block == OOC_SLAB,
              f"ooc plan: {pl.describe()}")
    done = [(tag, kw) + ooc_run(dev, cache, g, tag, pl, **kw)
            for tag, kw, pl in runs]
    # phase 22's idle share of this path, here while the cache exists
    idle_profile(f"phase 21 out of core, labels, {OOC_IDLE_PERMS}",
                 lambda: float(pipeline.pipeline(
                     cache, g, metric="braycurtis", n_perms=OOC_IDLE_PERMS,
                     seed=0, device_budget_bytes=OOC_BUDGET,
                     device=dev).f_stat), dev, warm=False)
    t0 = time.perf_counter()
    x = torch.from_numpy(cache.to_array()).to(dev)
    load_s = time.perf_counter() - t0
    for (tag, kw, res, dt), (_, _, pl) in zip(done, runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pipeline.pipeline(x, g, metric=pl.metric, seed=0,
                                materialize="fused", row_block=OOC_SLAB,
                                device=dev, **kw)
        float(ref.f_stat)
        ref_s = time.perf_counter() - t0
        ooc_identical(f"EMP {tag}", res, ref)
        log(f"[smoke] ooc {tag}: F, p, s_T and the null equal the resident "
            f"table's in-memory fused bridge (row_block {OOC_SLAB}) bit for "
            f"bit; resident {ref_s:.3f}s (+ {load_s:.3f}s to read the "
            f"cache and copy it up once) against {dt:.3f}s out of core")
    del x


def phase_ooc(dev):
    """Phase 21: (a) identity at small sizes, (b) the realistic cell. The
    caches live in a temporary directory, removed at the end."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="repro_torch_ooc.")
    try:
        ooc_row_blocks_identity(dev, root)
        ooc_pipeline_identity(dev, root)
        ooc_emp(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 22: telemetry. (a) traced against untraced at the EMP shape: the
# spans each path must show (the trees the CPU parity tests hold the port
# to, tests/test_torch_obs.py), and the guard on the traffic models: no
# traced stage may read above TRACE_HBM_FRACTION of the HBM peak. (b) the
# device idle share of each main path from a torch.profiler trace.
TRACE_HBM_FRACTION = 1.05
IDLE_TOP_OPS = 5
IDLE_GAPS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
IDLE_SHARES = []      # (path, window ms, busy ms, idle share), in run order


def obs_tree(events) -> dict:
    """{(name, parent, depth): count} of an obs event buffer."""
    import collections
    return dict(collections.Counter(
        (e["name"], e["args"].get("parent"), e["args"]["depth"])
        for e in events))


def traced_run(tag, fn, tree, chunk_span, kernel, path):
    """fn() untraced and then traced (obs on, spans exported to `path`),
    after one warm-up run: F, p and every null F equal bit for bit; the
    exported JSON loads and its span tree is `tree`; engine.perm_chunks,
    the `chunk_span` spans and the `kernel` launches of the traced run
    agree, and each cuda.launches.* counter equals the run's LAUNCHES.
    Returns (untraced s, traced s)."""
    import torch
    from repro_torch import obs
    float(fn(None).f_stat)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = fn(None)
    float(plain.f_stat)
    t_plain = time.perf_counter() - t0
    obs.clear()
    obs.metrics.reset()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced = fn(path)
    float(traced.f_stat)
    t_traced = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    with open(path) as f:
        doc = json.load(f)
    got = obs_tree(doc["traceEvents"])
    snap = obs.metrics.snapshot()
    from repro_torch.obs import cudahooks
    cuda_launches = cudahooks.launch_counts(snap)
    pairs = ([(plain, traced)] if plain.terms is None
             else list(zip(plain.terms, traced.terms)))
    same = all(torch.equal(a.f_stat, b.f_stat)
               and torch.equal(a.p_value, b.p_value)
               and torch.equal(a.f_perms, b.f_perms) for a, b in pairs)
    chunks = snap["counters"].get("engine.perm_chunks", 0)
    n_spans = sum(v for (name, _, _), v in got.items() if name == chunk_span)
    log(f"[smoke] traced {tag}: untraced {t_plain:.3f}s, traced "
        f"{t_traced:.3f}s; F={float(traced.f_stat):.7g} "
        f"p={float(traced.p_value):.6g}; {len(doc['traceEvents'])} spans "
        f"{sorted(got.items())}; engine.perm_chunks={chunks:g}, "
        f"{chunk_span} spans {n_spans}, launches {launches}")
    check(same, f"traced {tag}: F, p or the null differ from the "
          "untraced run")
    check(got == tree, f"traced {tag}: span tree {got} != {tree}")
    check(chunks == n_spans == launches.get(kernel, 0) > 0,
          f"traced {tag}: engine.perm_chunks {chunks}, {chunk_span} spans "
          f"{n_spans}, {kernel} launches {launches}")
    check(cuda_launches == {k: float(v) for k, v in launches.items()},
          f"traced {tag}: cuda.launches {cuda_launches} != LAUNCHES "
          f"{launches}")
    return t_plain, t_traced


def merged(intervals):
    """The union of (start, end) intervals, sorted and merged."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_profile(tag, fn, dev, warm=True, events_out=None, lead=None):
    """One warm run of fn() under torch.profiler (CPU and CUDA) with obs
    tracing on, so its spans show as ranges. From the exported Chrome
    trace: the window (the run's own range, its final sync included), the
    device's busy time (the union of kernel, memcpy and memset intervals
    on every stream), the idle share 1 - busy / window, the device
    operations that took the most time and the longest idle gaps, each
    with the innermost obs span open across it. Fails unless the trace
    holds at least as many device kernels as the run's counted launches
    (an empty trace cannot pass). warm=False: the caller ran the path
    just before. events_out: a list that receives the trace's complete
    events (phase 23 reads its copies from them). lead: run under the
    profiler before the window opens, so that the trace is recording
    when it does (a profile's first ~tens of ms of device activity may
    be dropped: phase 23 lost its first request's copies once)."""
    import tempfile
    import torch
    from repro_torch import obs
    from torch.profiler import ProfilerActivity, profile, record_function
    plain_ms = None
    if warm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    zero_launches()
    obs.clear()
    with obs.session(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        if lead is not None:
            lead()
            torch.cuda.synchronize(dev)
        with record_function("smoke.window"):
            fn()
            torch.cuda.synchronize(dev)
    launched = sum(launch_counts().values())
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans = {e["name"] for e in obs.events()}
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if events_out is not None:
        events_out.extend(xs)
    wins = [e for e in xs if e.get("name") == "smoke.window"
            and e.get("cat") == "user_annotation"]
    check(len(wins) == 1, f"idle {tag}: the profile has {len(wins)} "
          f"window ranges; categories {sorted({e.get('cat') for e in xs})}")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev_ops = [e for e in xs if e.get("cat") in DEVICE_CATS]
    kernels = sum(e.get("cat") == "kernel" for e in dev_ops)
    busy_iv = merged((max(w0, float(e["ts"])),
                      min(w1, float(e["ts"]) + float(e["dur"])))
                     for e in dev_ops
                     if float(e["ts"]) < w1 and float(e["ts"]) + float(
                         e["dur"]) > w0)
    busy = sum(b - a for a, b in busy_iv)
    window = w1 - w0
    idle = 1.0 - busy / window
    by_op = {}
    for e in dev_ops:
        name = e["name"][:60]
        c, t = by_op.get(name, (0, 0.0))
        by_op[name] = (c + 1, t + float(e["dur"]))
    top = sorted(by_op.items(), key=lambda kv: -kv[1][1])[:IDLE_TOP_OPS]
    edges = [w0] + [v for iv in busy_iv for v in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)), reverse=True)
    ranges = [e for e in xs if e.get("cat") == "user_annotation"
              and e.get("name") in spans]

    def innermost(a, b):
        mid = (a + b) / 2
        open_ = [e for e in ranges
                 if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        return (min(open_, key=lambda e: float(e["dur"]))["name"]
                if open_ else "(no obs span)")
    gap_txt = "; ".join(f"{g / 1e3:.3f} ms at +{(a - w0) / 1e3:.3f} ms in "
                        f"{innermost(a, b)}" for g, a, b in gaps[:IDLE_GAPS])
    top_txt = "; ".join(f"{name} x{c} {t / 1e3:.3f} ms"
                        for name, (c, t) in top)
    IDLE_SHARES.append((tag, window / 1e3, busy / 1e3, idle))
    # the profiler slows the host's launches, so beside the profile's
    # window: the same run's time unprofiled and untraced (its warm-up)
    plain = ("" if plain_ms is None else
             f" (unprofiled and untraced {plain_ms:.3f} ms: busy "
             f"{busy / 1e3 / plain_ms:.1%} of it)")
    log(f"[smoke] idle {tag}: window {window / 1e3:.3f} ms, busy "
        f"{busy / 1e3:.3f} ms, idle share {idle:.4f}{plain}; {kernels} device "
        f"kernels, {launched} counted launches; top device ops: {top_txt}; "
        f"longest idle gaps: {gap_txt}; {card_line()}")
    check(kernels >= launched > 0,
          f"idle {tag}: the profile holds {kernels} device kernels, fewer "
          f"than the run's {launched} counted launches (no CUPTI trace?)")
    return idle


def phase_telemetry(dev, x_np, grouping, cache_dir):
    """Phase 22: (a) traced against untraced at the EMP shape with the
    report and the traffic models' guard, (b) the device idle share of
    phases 3, 6, 9, 12 and 15's paths (phase 21 profiled its own)."""
    import torch
    from repro_torch import engine, hw, obs, pipeline
    from repro_torch.core.distance import distance_matrix
    from repro_torch.pipeline import registry
    x = torch.from_numpy(x_np).to(dev)
    g = torch.from_numpy(grouping).to(dev)
    cov, _, _, _ = emp_design(dev, x_np, grouping)
    dm = distance_matrix(x, "braycurtis")
    chunk, n_fused = fused_plan()
    _, n_cols = cols_plan()
    n_slabs = -(-EMP_N // STREAM_ROWS)
    base = dict(metric="braycurtis", n_perms=EMP_PERMS, seed=0, device=dev)

    def pipe(**kw):
        return lambda path: pipeline.pipeline(x, g, trace=path, **base, **kw)

    def run_d(path):
        if path is None:
            return engine.run(dm, g, n_perms=EMP_PERMS, seed=0, device=dev)
        with obs.session(path):
            return engine.run(dm, g, n_perms=EMP_PERMS, seed=0, device=dev)
    sw = {("engine.sw", None, 0): 1,
          ("engine.sw_chunk", "engine.sw", 1): 2}
    cases = [
        ("labels, fused-kernel bridge", pipe(),
         {("bridge.fused-kernel", None, 0): 1,
          ("fusedk.chunk", "bridge.fused-kernel", 1): n_fused},
         "fusedk.chunk", "fused_sw"),
        ("covariates, fused-kernel bridge", pipe(covariates=cov),
         {("bridge.fused-kernel", None, 0): 1,
          ("fusedk.chunk", "bridge.fused-kernel", 1): n_cols},
         "fusedk.chunk", "fused_sw_cols"),
        ("labels, stream bridge (3 GiB)",
         pipe(matrix_budget_bytes=BRIDGE_BUDGETS["stream"]),
         {("stage1.braycurtis", None, 0): 1,
          ("stream.mat2_block", "stage1.braycurtis", 1): n_slabs, **sw},
         "engine.sw_chunk", "brute"),
        ("engine.run on the resident D", run_d, sw, "engine.sw_chunk",
         "brute")]
    obs.clear()
    obs.metrics.reset()
    times = {}
    for i, (tag, fn, tree, span, kernel) in enumerate(cases):
        times[tag] = traced_run(tag, fn, tree, span, kernel,
                                os.path.join(cache_dir, f"trace{i}.json"))
    # the traces of the four traced runs: the report and the guard
    obs.clear()
    obs.metrics.reset()
    with obs.session():
        for _, fn, _, _, _ in cases:
            float(fn(None).f_stat)
    text = obs.report(backend="cuda", file=None)
    log("[smoke] obs.report(backend='cuda') of the four traced runs:\n"
        + text)
    limit = TRACE_HBM_FRACTION * hw.H100_SXM.hbm_bandwidth / 1e9
    rows = obs.stage_rows(backend="cuda")
    for r in rows:
        log(f"[smoke] traced stage {r['stage']}: {r['calls']} calls, "
            f"{r['predicted_mib']:.1f} MiB predicted in "
            f"{r['measured_s']:.4f}s, {r['achieved_gbps']:.1f} GB/s "
            f"({r['achieved_gbps'] / (hw.H100_SXM.hbm_bandwidth / 1e9):.1%}"
            f" of the HBM peak); {card_line()}")
        check(r["achieved_gbps"] <= limit,
              f"traced stage {r['stage']} reads {r['achieved_gbps']:.1f} "
              f"GB/s, above {TRACE_HBM_FRACTION:.0%} of the HBM peak: its "
              "traffic model counts bytes the card cannot move")
    check({r["stage"] for r in rows} == {
        "bridge.fused-kernel", "engine.sw", "stage1.braycurtis"},
        f"expected the traffic-model stages, got {rows}")
    obs.clear()
    obs.metrics.reset()

    # (b) the device idle share per path
    idle_profile("phase 3 engine.run (brute, 3,999)",
                 lambda: float(run_d(None).f_stat), dev)
    for bridge, budget in BRIDGE_BUDGETS.items():
        idle_profile(f"phase 6 {bridge} bridge", lambda b=budget: float(
            pipeline.pipeline(x, g, matrix_budget_bytes=b,
                              **base).f_stat), dev)
    idle_profile("phase 9 labels, fused-kernel bridge",
                 lambda: float(pipeline.pipeline(x, g, **base).f_stat), dev)
    idle_profile("phase 12 covariates, fused-kernel bridge",
                 lambda: float(pipeline.pipeline(
                     x, g, covariates=cov, **base).f_stat), dev)
    idle_profile("phase 15 labels bf16", lambda: float(pipeline.pipeline(
        x, g, fused_tuning=registry.precision_tuning("bf16"),
        **base).f_stat), dev)
    log("[smoke] idle shares: " + "; ".join(
        f"{tag} {share:.4f} ({busy:.1f} of {win:.1f} ms)"
        for tag, win, busy, share in IDLE_SHARES) + f"; {card_line()}")
    check(len(IDLE_SHARES) == 7, f"idle shares of 7 paths: {IDLE_SHARES}")
    for tag, (t_plain, t_traced) in times.items():
        log(f"[smoke] traced {tag}: {t_traced / t_plain:.3f}x the untraced "
            "time")


# ---------------------------------------------------------------------------
# Phase 23: serving on the card (repro_torch.serve).
# ---------------------------------------------------------------------------

SENTINEL_N, SENTINEL_PAD, SENTINEL_P = 3000, 4096, 128
SERVE_SIZES = (1500, 2200, 2900, 3600, 4300, 5000, 5700, 6400, 7100, 7800,
               8500, 9000)
SERVE_PERMS, SERVE_BLOCK, SERVE_WORKERS, SERVE_BATCH = 999, 128, 3, 4
SERVE_DESIGN_N = 4000
SERVE_CLI = ["permanova", "--batch", "4", "--inject-death", "--device",
             "cuda"]
SERVE_CLI_LAUNCHES = 4 * 6 * 7      # 4 runs of 6 studies, 7 blocks of 32
SERVE_COPY_SLACK = 2 ** 20          # bytes a request may copy beyond its
                                    # operands (the draws' seeds, scalars)


def serve_sentinel_checks(dev):
    """(a) Each s_W kernel on a study of n = 3,000 zero-padded to 4,096
    whose pad rows carry the sentinel label G (the masked draw of one
    serving block): against its plain version on the padded input and
    against the same kernel on the unpadded study, at the repo's bar."""
    import torch
    from repro_torch.core import distance, permutations
    from repro_torch.data.microbiome import synthetic_study
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.permanova_sw import ops, ref
    x, g = synthetic_study(SENTINEL_N, EMP_FEATURES, EMP_GROUPS,
                           effect_size=1.0, seed=23)
    xt = distance.ROW_METRICS["braycurtis"].prepare(
        torch.from_numpy(x).to(dev)).contiguous()
    d = dops.pairwise_distance(xt, metric="braycurtis")
    mat2 = (d * d).contiguous()
    m_pad = torch.zeros((SENTINEL_PAD, SENTINEL_PAD), device=dev)
    m_pad[:SENTINEL_N, :SENTINEL_N] = mat2
    g_pad = torch.full((SENTINEL_PAD,), EMP_GROUPS, dtype=torch.int32,
                       device=dev)
    g_pad[:SENTINEL_N] = torch.from_numpy(g).to(dev)
    labels = permutations.masked_permutation_batch(g_pad, SENTINEL_N, 0,
                                                   SENTINEL_P, seed=0)
    inv_gs = permutations.inv_group_sizes(g_pad, EMP_GROUPS)
    plain = ref.sw_ref(m_pad, labels, inv_gs)
    unpadded_labels = labels[:, :SENTINEL_N].contiguous()
    for v in ops.VARIANTS:
        got = ops.permanova_sw(m_pad, labels, inv_gs, variant=v)
        unpadded = ops.permanova_sw(mat2, unpadded_labels, inv_gs,
                                    variant=v)
        torch.cuda.synchronize()
        e_plain, e_unpad = rel_err(got, plain), rel_err(got, unpadded)
        log(f"[smoke] serve sentinel {v:9s} (n, n_pad, P, G)="
            f"{(SENTINEL_N, SENTINEL_PAD, SENTINEL_P, EMP_GROUPS)}: "
            f"max_rel_err {e_plain:.3e} vs the plain version on the padded "
            f"input, {e_unpad:.3e} vs the unpadded kernel call")
        check(bool(torch.isfinite(got).all())
              and torch.allclose(got, plain, rtol=RTOL, atol=ATOL)
              and torch.allclose(got, unpadded, rtol=RTOL, atol=ATOL),
              f"serve sentinel: the {v} kernel on sentinel-padded labels "
              f"misses the bar ({e_plain:.3e} vs plain, {e_unpad:.3e} vs "
              "unpadded)")


def serve_cli_stream():
    """(b) The slice's entry point on the card: `repro_torch.launch.serve
    permanova --batch 4 --inject-death` (6 studies, n 18-40, 199
    permutations, block 32): serial, batched at max_batch 4 (bit for
    bit, then a warm replay with no kernel build or load and no bucket
    miss) and with worker 0 killed after 2 blocks (bit for bit); the
    brute kernel once a block."""
    from repro_torch.launch import serve as serve_cli
    zero_launches()
    t0 = time.perf_counter()
    rc = serve_cli.main(list(SERVE_CLI))
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    log(f"[smoke] serve CLI {' '.join(SERVE_CLI)}: rc {rc} in {dt:.2f}s, "
        f"launches {launches}")
    check(rc == 0, f"serve CLI exited {rc}")
    check(set(launches) == {"brute"}
          and launches["brute"] >= SERVE_CLI_LAUNCHES,
          f"serve CLI: the brute kernel once a block at least "
          f"({SERVE_CLI_LAUNCHES}), nothing else: {launches}")


def serve_requests():
    """(c)'s stream: 12 features requests (n over 1,500-9,000), a strata
    and a covariate-design request at n = 4,000, and the EMP request
    (n = 25,145, 3,999 permutations); Bray-Curtis, 128 features."""
    from repro_torch.data.microbiome import synthetic_design, synthetic_study
    from repro_torch.serve import StudyRequest
    reqs = []
    for i, n in enumerate(SERVE_SIZES):
        x, g = synthetic_study(n, EMP_FEATURES, EMP_GROUPS, effect_size=0.3,
                               seed=200 + i)
        reqs.append(StudyRequest(grouping=g, x=x, n_perms=SERVE_PERMS,
                                 seed=i, request_id=f"n{n}"))
    x, g = synthetic_study(SERVE_DESIGN_N, EMP_FEATURES, EMP_GROUPS,
                           effect_size=0.3, seed=300)
    cov, strata, _ = synthetic_design(
        SERVE_DESIGN_N, covariate_names=DESIGN_COVARIATES,
        n_strata=DESIGN_STRATA, seed=0)
    reqs.append(StudyRequest(grouping=g, x=x, strata=strata,
                             n_perms=SERVE_PERMS, seed=20,
                             request_id="strata"))
    reqs.append(StudyRequest(grouping=g, x=x, covariates=cov,
                             n_perms=SERVE_PERMS, seed=21,
                             request_id="covariates"))
    x, g = synthetic_study(EMP_N, EMP_FEATURES, EMP_GROUPS, effect_size=1.0,
                           seed=0)
    reqs.append(StudyRequest(grouping=g, x=x, n_perms=EMP_PERMS, seed=0,
                             request_id="emp"))
    return reqs


def serve_expected(req) -> dict:
    """The launches a served features request makes: its distance kernel
    once (stage 1), brute once a 128-permutation block on a label mode;
    a dense design's per-column companion is plain torch."""
    blocks = -(-(req.n_perms + 1) // SERVE_BLOCK)
    out = {"braycurtis": 1}
    if req.covariates is None:
        out["brute"] = blocks
    return out


def serve_copy_bytes(req) -> tuple:
    """(host -> device, device -> host) bytes the server moves for one
    features request: the features and every operand once (mat2 at the
    bucket, labels, weights, strata or the basis), the distances back,
    and each block's s_W back."""
    from repro_torch.serve.permanova import _next_bucket
    n, d = req.x.shape
    n_pad = _next_bucket(n, None)
    h2d = 4 * n * d + 4 * n_pad * n_pad
    n_total = req.n_perms + 1
    if req.covariates is not None:           # the basis and the strata
        return (h2d + 4 * n_pad * (DESIGN_K + 1),
                4 * n * n + 4 * n_total * DESIGN_K)
    h2d += 4 * n_pad + 4 * EMP_GROUPS        # labels, 1 / group sizes
    if req.strata is not None:
        h2d += 4 * n_pad
    return h2d, 4 * n * n + 4 * n_total


def serve_copies(events) -> dict:
    """{request index: (H2D bytes, H2D ms, D2H bytes, D2H ms, memcpys)}
    of the profiled window's `serve.step` ranges, from the memcpy events
    whose host call (the cuda_runtime
    event of the same correlation id, on the host's clock like the obs
    ranges) lies inside each `serve.step` range; the device's timestamps
    are on another clock and may sit a request off."""
    win = next(e for e in events if e.get("name") == "smoke.window"
               and e.get("cat") == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    steps = [e for e in events if e.get("name") == "serve.step"
             and e.get("cat") == "user_annotation"
             and w0 <= float(e["ts"]) <= w1]
    host_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    copies = [(host_ts.get(c["args"].get("correlation"), float(c["ts"])),
               c) for c in events if c.get("cat") == "gpu_memcpy"]
    out = {}
    for i, s in enumerate(sorted(steps, key=lambda e: float(e["ts"]))):
        a, b = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        tot = {"HtoD": [0, 0.0], "DtoH": [0, 0.0]}
        n = 0
        for t, c in copies:
            kind = next((k for k in tot if k in c["name"]), None)
            if kind is None or not a <= t <= b:
                continue
            n += 1
            tot[kind][0] += int(c["args"]["bytes"])
            tot[kind][1] += float(c["dur"]) / 1e3
        out[i] = (*tot["HtoD"], *tot["DtoH"], n)
    return out


def serve_same(a, b) -> bool:
    import torch
    pairs = [(a.result, b.result)] + list(zip(a.result.terms or (),
                                              b.result.terms or ()))
    return all(torch.equal(u.f_stat, v.f_stat)
               and torch.equal(u.p_value, v.p_value)
               and torch.equal(u.f_perms, v.f_perms) for u, v in pairs)


def serve_vs_unpadded(dev, req, res):
    """A served request against the port's own unpadded run on the same
    seed (pipeline() on the dense bridge: the distance kernel, then
    engine.run / run_design): F at rtol 1e-4, p equal, each null F within
    the f32 allowance (per term for the design). The masked draws are
    the unpadded draws, so only the summation order differs."""
    import numpy as np
    import torch
    from repro_torch import pipeline
    x = torch.from_numpy(req.x).to(dev)
    g = torch.from_numpy(req.grouping).to(dev)
    ref = pipeline.pipeline(x, g, metric="braycurtis", n_perms=req.n_perms,
                            seed=req.seed, strata=req.strata,
                            covariates=req.covariates,
                            matrix_budget_bytes=BRIDGE_BUDGETS["dense"],
                            device=dev)
    got = res.result
    if req.covariates is not None:
        allow = design_null_allowance(got, sum(t.df for t in got.terms) + 1)
        pairs = [(t.name, t, u) for t, u in zip(got.terms, ref.terms)]
    else:
        c = (got.n_objects - EMP_GROUPS) / (EMP_GROUPS - 1)
        allow = {None: 2 * SW_MAIN_RTOL * (ref.f_perms.double().cpu().abs()
                                           + c)}
        pairs = [(None, got, ref)]
    worst = 0.0
    for name, t, u in pairs:
        d_null = (t.f_perms.double().cpu() - u.f_perms.double().cpu()).abs()
        a = allow[name].double().cpu()
        worst = max(worst, float((d_null / a).max()))
        f_err = abs(float(t.f_stat) - float(u.f_stat)) / abs(float(u.f_stat))
        # p equal: the served p is float64, pipeline()'s float32, both
        # (count + 1) / (n_perms + 1) correctly rounded
        same_p = np.float32(float(t.p_value)) == np.float32(float(u.p_value))
        check(f_err <= RTOL and same_p
              and bool((d_null <= a).all()),
              f"serve {req.request_id} term {name}: served F "
              f"{float(t.f_stat)!r} p {float(t.p_value)!r} vs unpadded "
              f"{float(u.f_stat)!r} {float(u.p_value)!r}; null "
              f"{float((d_null / a).max()):.3g}x the allowance")
    return worst


def serve_stream(dev, tmpdir):
    """(c) and (d): the card-sized stream served serially and coalesced,
    each result held to the port's unpadded run; then chaos and restart
    on the EMP request, each bit for bit the clean serial result."""
    import torch
    from repro_torch import obs
    from repro_torch.runtime.faultinject import FaultInjector, VirtualClock
    from repro_torch.serve import (PermanovaServer, StudyRequest,
                                   serve_stats_from_events)

    def server(**kw):
        return PermanovaServer(workers=SERVE_WORKERS, block=SERVE_BLOCK,
                               device=dev, **kw)
    reqs = serve_requests()
    srv = server(max_batch=SERVE_BATCH)
    # serially, one request at a time, launches counted around each
    serial, per_launch = [], []
    obs.clear()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with obs.session():
        for req in reqs:
            zero_launches()
            serial.append(srv.process(req))
            per_launch.append({k: v for k, v in launch_counts().items()
                               if v})
        stats = serve_stats_from_events(obs.events())
        spans = [e for e in obs.events() if e["name"] in (
            "serve.stage1", "serve.block")]
    t_serial = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start
    log(f"[smoke] serve stream serially: {len(reqs)} requests in "
        f"{t_serial:.3f}s; serve.step spans: {stats['requests']} requests, "
        f"{stats['requests_per_s']:.4f} requests/s, p50 "
        f"{stats['p50_s']:.4f}s, p99 {stats['p99_s']:.4f}s; device peak "
        f"above the start {peak / 2**20:.1f} MiB; {card_line()}")
    stage1 = {}
    for e in spans:
        stage1.setdefault(e["name"], []).append(e["dur"] / 1e6)
    log(f"[smoke] serve stream serially: serve.stage1 "
        f"{sum(stage1.get('serve.stage1', [])):.3f}s over "
        f"{len(stage1.get('serve.stage1', []))} spans, serve.block "
        f"{sum(stage1.get('serve.block', [])):.3f}s over "
        f"{len(stage1.get('serve.block', []))} spans")
    for req, res, launches in zip(reqs, serial, per_launch):
        check(res.status == "ok", f"serve {req.request_id}: {res.status} "
              f"{res.error}")
        want = serve_expected(req)
        h2d, d2h = serve_copy_bytes(req)
        log(f"[smoke] serve {req.request_id} (n={req.x.shape[0]}, "
            f"{res.bucket}): wall {res.wall_s:.4f}s, F="
            f"{float(res.result.f_stat):.7g} p={float(res.result.p_value)}"
            f", launches {launches}, modelled copies H2D {h2d / 2**20:.1f} "
            f"MiB, D2H {d2h / 2**20:.1f} MiB")
        check(launches == want, f"serve {req.request_id}: launches "
              f"{launches}, expected {want}")
    # coalesced
    zero_launches()
    srv_b = server(max_batch=SERVE_BATCH)
    obs.clear()
    t0 = time.perf_counter()
    with obs.session():
        snap = obs.metrics.snapshot()
        batched = srv_b.serve(reqs, batched=True)
        b_stats = serve_stats_from_events(obs.events())
        n_batches = obs.metrics.counter_delta(snap).get("serve.batches", 0)
    t_batched = time.perf_counter() - t0
    b_launches = {k: v for k, v in launch_counts().items() if v}
    want_total = {}
    for w in map(serve_expected, reqs):
        for k, v in w.items():
            want_total[k] = want_total.get(k, 0) + v
    log(f"[smoke] serve stream coalesced (max_batch {SERVE_BATCH}): "
        f"{t_batched:.3f}s, {n_batches:.0f} batches, "
        f"{b_stats['requests_per_s']:.4f} requests/s, p50 "
        f"{b_stats['p50_s']:.4f}s, p99 {b_stats['p99_s']:.4f}s, launches "
        f"{b_launches}")
    check(b_launches == want_total, f"serve coalesced: launches "
          f"{b_launches}, expected {want_total}")
    for a, b in zip(serial, batched):
        check(b.status == "ok" and serve_same(a, b),
              f"serve {a.request_id}: coalesced != serial bit for bit")
    log("[smoke] serve stream: coalesced == serial bit for bit (F, p, "
        "every null F, every term)")
    # against the port's unpadded runs
    t0 = time.perf_counter()
    worst = {}
    for req, res in zip(reqs, serial):
        worst[req.request_id] = serve_vs_unpadded(dev, req, res)
    log(f"[smoke] serve stream vs the unpadded pipeline() runs "
        f"({time.perf_counter() - t0:.2f}s): F within rtol {RTOL}, p equal, "
        f"null F within the f32 allowance; worst null / allowance "
        f"{ {k: round(v, 4) for k, v in worst.items()} }")
    # the idle share and the copies of one warm serial replay
    events = []
    idle_profile("phase 23 serving stream, warm serial replay",
                 lambda: srv.serve(reqs), dev, warm=False,
                 events_out=events, lead=lambda: (srv.process(reqs[0]),
                                                  time.sleep(0.5)))
    for i, (h2d, h2d_ms, d2h, d2h_ms, n) in serve_copies(events).items():
        req = reqs[i]
        mh2d, md2h = serve_copy_bytes(req)
        log(f"[smoke] serve copies {req.request_id}: H2D "
            f"{h2d / 2**20:.1f} MiB in {h2d_ms:.3f} ms, D2H "
            f"{d2h / 2**20:.1f} MiB in {d2h_ms:.3f} ms ({n} memcpys; "
            f"modelled {mh2d / 2**20:.1f} / {md2h / 2**20:.1f} MiB)")
        # beside the operands, the draws copy a few bytes a sub-block
        check(0 <= h2d - mh2d < SERVE_COPY_SLACK
              and 0 <= d2h - md2h < SERVE_COPY_SLACK,
              f"serve copies {req.request_id}: {h2d} / {d2h} B moved, the "
              f"server must move {mh2d} / {md2h} B")
    # (d) chaos and restart on the EMP request
    emp = reqs[-1]
    clean = serial[-1]

    def emp_req(**kw):
        fields = dict(grouping=emp.grouping, x=emp.x, n_perms=emp.n_perms,
                      seed=emp.seed, request_id="emp")
        fields.update(kw)
        return StudyRequest(**fields)
    t0 = time.perf_counter()
    res = server(injector=FaultInjector(seed=1).kill_worker_after_blocks(
        0, 2)).process(emp_req())
    check(res.status == "ok" and serve_same(res, clean)
          and any("kill worker=0" in h for h in res.report.history),
          "serve chaos: a worker death changed the EMP result")
    log(f"[smoke] serve chaos EMP worker death: == clean bit for bit "
        f"({time.perf_counter() - t0:.2f}s; died {res.report.workers_died},"
        f" committed {res.report.committed} of {res.report.n_blocks})")
    # one degraded run feeds both resumes: a new server from the
    # checkpoint first (it removes the checkpoint), then the first
    # server's resume_degraded() from the partial s_W it kept
    t0 = time.perf_counter()
    ckpt = os.path.join(tmpdir, "serve_ckpt")
    srv_d = server(clock=VirtualClock(), ckpt_dir=ckpt, checkpoint_every=2,
                   injector=FaultInjector(seed=2).delay_block(None, 0.2))
    deg = srv_d.process(emp_req(deadline_s=1.0))
    m = deg.n_perms_done
    lo, hi = deg.p_ci or (None, None)
    check(deg.status == "degraded" and 0 < m < emp.n_perms
          and torch.equal(deg.result.f_perms, clean.result.f_perms[: m + 1])
          and lo <= float(clean.result.p_value) <= hi
          and os.path.isdir(os.path.join(ckpt, "emp")),
          f"serve chaos: the degraded EMP result ({deg.status}, {m} "
          f"permutations, CI {deg.p_ci}) is not the clean null's prefix "
          "with a checkpoint")
    log(f"[smoke] serve chaos EMP deadline: degraded at {m} permutations "
        f"(p {float(deg.result.p_value):.6g}, CI ({lo:.6g}, {hi:.6g}) holds "
        f"the clean p {float(clean.result.p_value):.6g}), checkpointed "
        f"({time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    r2 = server(ckpt_dir=ckpt).process(emp_req())
    check(r2.status == "ok" and r2.report.committed < r2.report.n_blocks
          and serve_same(r2, clean)
          and not os.path.exists(os.path.join(ckpt, "emp")),
          f"serve restart: the resumed EMP result != clean (committed "
          f"{r2.report.committed} of {r2.report.n_blocks})")
    log(f"[smoke] serve restart EMP: a new server resumed the checkpoint "
        f"({r2.report.committed} of {r2.report.n_blocks} blocks run) == "
        f"clean bit for bit ({time.perf_counter() - t0:.2f}s)")
    t0 = time.perf_counter()
    (exact,) = srv_d.resume_degraded()
    check(exact.status == "ok" and serve_same(exact, clean)
          and deg.final.result() is exact,
          "serve chaos: resume_degraded() != the clean EMP result")
    log(f"[smoke] serve chaos EMP resume_degraded(): == clean bit for bit "
        f"({exact.report.committed} of {exact.report.n_blocks} blocks run, "
        f"{time.perf_counter() - t0:.2f}s)")
    shutil.rmtree(ckpt, ignore_errors=True)


def phase_serving(dev, cache_dir):
    """Phase 23: serving on the card. (a) the sentinel checks, (b) the
    CLI stream, (c) the card-sized stream, (d) chaos and restart."""
    serve_sentinel_checks(dev)
    serve_cli_stream()
    serve_stream(dev, cache_dir)


def main() -> int:
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # the run's own autotune cache, removed at its end: no winner outlives
    # it, and phases 1-18 plan from the heuristics
    cache_dir = tempfile.mkdtemp(prefix="repro_torch_autotune.")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        cache_dir, "autotune.json")
    try:
        return run_phases(torch, dev, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run_phases(torch, dev, cache_dir) -> int:
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    phase_header()
    log(f"[smoke] phase 1 (header, build) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    worst = phase_kernels(dev)
    log(f"[smoke] phase 2 (kernels vs plain) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    mat2, g_dev, paths, f_p_main, (x, grouping) = phase_main_path(dev)
    log(f"[smoke] phase 3 (EMP main path) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    rows = phase_timings(dev, mat2, g_dev, paths, worst)
    del mat2
    phase_reference(dev)
    log(f"[smoke] phase 4 (timings, reference) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    dist_worst = phase_distance_kernels(dev, x)
    log(f"[smoke] phase 5 (distance kernels vs plain) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    dist_paths, dense = phase_pipeline(dev, x, grouping, f_p_main)
    log(f"[smoke] phase 6 (features path) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    rows += phase_distance_timings(dev, x, dist_paths, dist_worst)
    log(f"[smoke] phase 7 (distance timings) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    fused_check = phase_fused_kernel(dev, x, grouping)
    log(f"[smoke] phase 8 (fused kernel vs plain) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    fused_paths = phase_fused_pipeline(dev, x, grouping, f_p_main, dense)
    log(f"[smoke] phase 9 (features path, default budgets) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    rows.append(phase_fused_timings(dev, x, grouping, fused_paths,
                                    fused_check))
    log(f"[smoke] phase 10 (fused kernel timings) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    cols_check = phase_cols_kernel(dev, x, grouping)
    log(f"[smoke] phase 11 (fused_sw_cols vs plain) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    design_paths = phase_design_pipeline(dev, x, grouping)
    log(f"[smoke] phase 12 (design path, default budgets) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    rows.append(phase_cols_timings(dev, x, grouping, design_paths,
                                   cols_check))
    log(f"[smoke] phase 13 (fused_sw_cols timings) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    mode_check = phase_mode_kernels(dev, x, grouping)
    log(f"[smoke] phase 14 (feature modes vs plain) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    mode_paths = phase_mode_pipeline(dev, x, grouping)
    log(f"[smoke] phase 15 (features path at each precision) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    stream_rows, gbps = phase_stream(dev)
    rows += phase_mode_timings(dev, x, grouping, mode_paths, mode_check,
                               gbps)
    rows += stream_rows
    log(f"[smoke] phase 16 (feature mode and STREAM timings) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_budget(dev, x, grouping)
    log(f"[smoke] phase 17 (the fused-kernel bridge's budget) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_many(dev)
    log(f"[smoke] phase 18 (many-study runs) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_autotune(dev, x, grouping, f_p_main, cache_dir)
    log(f"[smoke] phase 19 (autotune) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_ordination(dev, x, grouping)
    log(f"[smoke] phase 20 (ordination) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_ooc(dev)
    log(f"[smoke] phase 21 (out of core) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_telemetry(dev, x, grouping, cache_dir)
    log(f"[smoke] phase 22 (telemetry) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    phase_serving(dev, cache_dir)
    log(f"[smoke] phase 23 (serving) {time.perf_counter() - t0:.2f}s")
    log(f"[smoke] total {time.perf_counter() - t_all:.2f}s")

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
