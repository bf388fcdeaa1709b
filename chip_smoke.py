#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`src/repro_torch`) on one H100.

    python3 chip_smoke.py

Phases, each timed:

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of the kernels from `csrc/` with nvcc.
2. Every permanova_sw kernel against its plain PyTorch version on the card
   at (n, P, G) = (57, 1, 3), (130, 5, 2), (2047, 37, 8): f32 at
   rtol=1e-4, atol=1e-5; the matmul kernel on bf16 mat2 against the plain
   version on the same bf16-rounded operands at rtol=1e-4, and against a
   float64 reference on the f32 operands at 5e-3 relative (the
   reference package's own bar for bf16).
3. The main path at the paper's EMP shape: synthetic_study(25145, 128, 8,
   effect 1.0) -> Bray-Curtis D -> engine.run(impl="auto", 3,999 perms),
   which the planner sends to the brute kernel in 2 streamed label
   chunks; then impl brute, tiled and matmul on the same explicit labels
   at 999 permutations, which must agree on F (rtol=1e-4) and exactly on
   p, and on the whole null distribution within what f32 s_W allows (see
   SW_MAIN_RTOL). The kernels' launch counts are set to 0 just before each
   of these four runs and read just after it: the auto run must launch
   the brute kernel once per chunk and nothing else (no chunk may take a
   CPU path), each pinned run its own kernel once per chunk and nothing
   else.
4. Each kernel timed at the shape the main path gives it, beside its plain
   version, one PyTorch library call where one computes the same
   function, and its bound on this card; at that shape each kernel's s_W
   must also match the plain version's within SW_MAIN_RTOL. Then
   engine.run on the card against engine.run on the CPU at n=300 (same
   seed, so the same labels).
5. Every pairwise-distance kernel (braycurtis, euclidean, jaccard,
   jaccard_packed) against its plain PyTorch version on the card at
   (nr, nc, d) = (57, 57, 3), (130, 130, 37), (2047, 2047, 128) and
   (256, 25145, 128), the stream bridge's slab at the EMP shape: f32 at
   rtol=1e-4, atol=1e-5 (the reference's own bar), and jaccard_packed
   equal to the jaccard kernel bit for bit on the same presence data.
6. The features path at the EMP shape through the entry point a user
   calls: pipeline(features, Bray-Curtis, 3,999 permutations, seed 0),
   once with a 6 GiB matrix budget (the planner picks the dense bridge:
   one braycurtis launch) and once with 3 GiB (the stream bridge: one
   launch per 256-row slab, 99), each launching the brute kernel twice
   and nothing else; F of the two bridges and of phase 3's engine.run
   (same seed, so the same labels) agree at rtol=1e-4 with p equal. Then
   each other distance kernel's own path, the dense bridge at 999
   permutations for euclidean (and aitchison), jaccard and jaccard with
   packed=1, whose F must equal the float jaccard's bit for bit.
7. Each distance kernel timed at the main path's shapes, (n, n, 128) for
   the dense bridge and the (256, n, 128) slab x 99 for the stream
   bridge, beside its plain version, torch.cdist for euclidean (the one
   PyTorch call that computes one of these functions), and its bound.

Prints, before the last line, a JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the exit code is non-zero and no result line
is printed. Without a CUDA device it exits with code 2.

Full-f32 matmuls: TF32 is switched off for torch.matmul and cuDNN below,
so the plain sw_matmul and the library call run in f32, as the
reference's f32 modes do.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

EMP_N, EMP_FEATURES, EMP_GROUPS, EMP_PERMS = 25145, 128, 8, 3999
CROSS_PERMS = 999
CHECK_SHAPES = [(57, 1, 3), (130, 5, 2), (2047, 37, 8)]
RTOL, ATOL = 1e-4, 1e-5
# At the EMP shape the part of s_W that depends on the permutation is
# s_A / s_T ~ (G - 1) / (n - 1) ~ 2.8e-4 of it, so rtol 1e-4 on s_W would
# pass a neighbouring permutation's s_W. Each kernel's s_W is held to its
# plain version at 1e-6 relative there (a few f32 ulps; neighbouring null
# s_W differ by ~1e-4), and two impls' null F to what that allows:
# |dF| <= 2 * SW_MAIN_RTOL * (F + (n - G) / (G - 1)), since
# F = (n - G) / (G - 1) * (s_T / s_W - 1).
SW_MAIN_RTOL = 1e-6
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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from repro_torch.kernels.permanova_sw import ops
    log(f"[smoke] card: {card_line()}")
    log(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # one nvcc per source, started together
    with ThreadPoolExecutor(2) as pool:
        libs = [f.result() for f in [pool.submit(m.load_library)
                                     for m in (ops, dops)]]
    log(f"[smoke] kernel build+load {time.perf_counter() - t0:.2f}s "
        f"({ops.SOURCE.name} -> {ops._build.library_path(ops.SOURCE).name}, "
        f"{dops.SOURCE.name} -> {dops._build.library_path(dops.SOURCE).name})"
        f" config {ops.kernel_config(libs[0])}")


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
            check(torch.allclose(got, plain, rtol=RTOL, atol=ATOL),
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
    return worst


def zero_launches():
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.permanova_sw import ops
    for counts in (ops.LAUNCHES, dops.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    """Every kernel's launches since zero_launches(), by kernel name."""
    from repro_torch.kernels.distance import ops as dops
    from repro_torch.kernels.permanova_sw import ops
    return {**ops.LAUNCHES, **dops.LAUNCHES}


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
    cross_chunks = -(-(CROSS_PERMS + 1)
                     // planner.chunk_for_budget(EMP_N, CROSS_PERMS + 1))
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
    labels_ms = cuda_ms(lambda: permutations.permutation_batch(
        g_dev, chunk, 2 * chunk, seed=0), reps=3)
    log(f"[smoke] timing labels    (n={EMP_N}, chunk={chunk}): "
        f"permutation_batch {labels_ms:.3f} ms per chunk")
    shapes = {"brute": chunk, "permblock": CROSS_PERMS + 1,
              "matmul": CROSS_PERMS + 1}
    rows = []
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
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err_abs = float((got - want).abs().max())
        err = rel_err(got, want)
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL)
              and err <= SW_MAIN_RTOL,
              f"{v} kernel != plain at the main-path shape: rel {err:.3e} "
              f"(limit {SW_MAIN_RTOL})")
        ms = cuda_ms(kern, reps=3 if v != "brute" else 2)
        plain_ms = cuda_ms(plain, reps=1, warm=lambda: plain(small))
        # the library yardstick for all three: one torch.matmul of mat2
        # with the (n, P*G) one-hot factor of these labels
        e = fstat.onehot_perm_factors(labels, inv_gs, mat2.dtype)
        e2d = e.permute(1, 0, 2).reshape(EMP_N, -1).contiguous()
        del e
        library_ms = cuda_ms(lambda: torch.matmul(mat2, e2d), reps=3)
        del e2d
        b_ms, b_by = bound_ms(mat2, labels, inv_gs, H100_SXM)
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
            log(f"[smoke] timing matmul    one-hot form "
                f"{onehot_flop(labels, inv_gs):.4g} FLOP = "
                f"{onehot_flop(labels, inv_gs) / ms / 1e9:.2f} TFLOP/s")

    # the matmul kernel on bf16 mat2 (the reference's bf16 mode)
    labels = permutations.permutation_batch(g_dev, 0, CROSS_PERMS + 1, seed=0)
    m16 = mat2.to(torch.bfloat16)
    ms16 = cuda_ms(lambda: ops.permanova_sw(m16, labels, inv_gs,
                                            variant="matmul"), reps=3)
    b16, by16 = bound_ms(m16, labels, inv_gs, H100_SXM)
    log(f"[smoke] timing matmul    (n={EMP_N}, P={CROSS_PERMS + 1}, "
        f"G={EMP_GROUPS}) bf16: kernel {ms16:.3f} ms, bound {b16:.3f} ms "
        f"({by16}); one-hot form "
        f"{onehot_flop(labels, inv_gs) / ms16 / 1e9:.2f} TFLOP/s")
    del m16
    return rows


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


def phase_distance_kernels(dev):
    """Every distance kernel against its plain version at
    DIST_CHECK_SHAPES; the (256, n, 128) slab is the EMP table's first 256
    rows against the whole table, as the stream bridge's first slab."""
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
    return worst


def phase_pipeline(dev, x_np, grouping, f_p_main):
    """pipeline() from the EMP features: the dense and the stream bridge,
    picked by the planner from the matrix budget, with each run's own
    launch counts; then each other distance kernel's own dense path."""
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
        t0 = time.perf_counter()
        res = pipeline.pipeline(x, g_dev, metric="braycurtis",
                                n_perms=EMP_PERMS, seed=0,
                                matrix_budget_bytes=budget, device=dev)
        f_b, p_b = float(res.f_stat), float(res.p_value)      # waits
        dt = time.perf_counter() - t0
        paths[bridge] = launch_counts()
        results[bridge] = (f_b, p_b)
        log(f"[smoke] pipeline {bridge:6s} n={EMP_N} perms={EMP_PERMS} "
            f"{dt:.3f}s end to end F={f_b:.7g} p={p_b:.6g} "
            f"launches={paths[bridge]}")
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
    return paths


def dist_bound_ms(kernel, a, b, chip) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time this card could take
    for the distances of a's rows against b's rows — inputs read once and
    the f32 output written once at the HBM rate, against the feature
    loop's operations at the f32 CUDA-core peak: 2 per (pair, feature)
    for the three float kernels (braycurtis: a subtract and an add of its
    magnitude; euclidean and jaccard: a fused multiply-add), 3 per (pair,
    word) for jaccard_packed (AND, popcount, add; the guide's table has
    no int32 row, and the f32 rate bounds it from below). The O(n^2)
    finalize and O(n d) row sums are left out, so this stays a lower
    bound."""
    nr, nc, w = a.shape[0], b.shape[0], a.shape[1]
    nbytes = (a.numel() + b.numel()) * a.element_size() + 4 * nr * nc
    ops_ = (3 if kernel == "jaccard_packed" else 2) * nr * nc * w
    t_bytes = nbytes / chip.hbm_bandwidth * 1e3
    t_ops = ops_ / chip.peak_flops_f32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_distance_timings(dev, x_np, paths, worst):
    """Each distance kernel at the main path's shapes: (n, n, 128) once
    (dense bridge), the (256, n, 128) slab 99 times (stream bridge)."""
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
        a, b = dense_ops[k]
        sa, sb = slab_ops[k]
        got = dops.pairwise_rect(a, b, kernel=k).fill_diagonal_(0.0)
        want = dref.REFS[k](a, b).fill_diagonal_(0.0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{k} kernel != plain at the main-path shape: abs {err:.3e}")
        if k.startswith("jaccard"):
            outs[k] = got
        del got, want
        ms = cuda_ms(lambda: dops.pairwise_rect(a, b, kernel=k), reps=3)
        plain_ms = cuda_ms(lambda: dref.REFS[k](a, b), reps=1,
                           warm=lambda: dref.REFS[k](sa, sb))
        slab_ms = cuda_ms(lambda: dops.pairwise_rect(sa, sb, kernel=k),
                          reps=10)
        slab_plain_ms = cuda_ms(lambda: dref.REFS[k](sa, sb), reps=3)
        library_ms = None
        if k == "euclidean":
            library_ms = cuda_ms(lambda: torch.cdist(a, b), reps=3)
        b_ms, b_by = dist_bound_ms(k, a, b, H100_SXM)
        sb_ms, sb_by = dist_bound_ms(k, sa, sb, H100_SXM)
        rows.append({
            "name": f"distance.{k}", "route": "cuda",
            "source": DIST_SOURCE, "replaces": DIST_REPLACES[k],
            "path": f"pipeline {own_path[k]}",
            "launches": paths[own_path[k]][k],
            "launches_by_path": {p: c[k] for p, c in paths.items()},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "shape": {"nr": EMP_N, "nc": EMP_N, "d": EMP_FEATURES,
                      "operand_cols": a.shape[1]},
            "max_abs_err_checks": worst[k],
            "stream_slab": {"nr": STREAM_ROWS, "nc": EMP_N, "ms": slab_ms,
                            "plain_ms": slab_plain_ms, "bound_ms": sb_ms,
                            "bound_by": sb_by, "slabs": n_slabs,
                            "launches": paths["stream"][k]},
        })
        log(f"[smoke] timing {k:14s} (n={EMP_N}, d={EMP_FEATURES}) dense: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{library_ms} ms, bound {b_ms:.3f} ms ({b_by}); slab "
            f"({STREAM_ROWS}, n): kernel {slab_ms:.4f} ms x {n_slabs} = "
            f"{slab_ms * n_slabs:.3f} ms, plain {slab_plain_ms:.3f} ms, "
            f"bound {sb_ms:.4f} ms ({sb_by}); max_abs_err {err:.3e}")
    check(torch.equal(outs["jaccard_packed"], outs["jaccard"]),
          "jaccard_packed != jaccard kernel bit for bit at the main shape")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
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
    dist_worst = phase_distance_kernels(dev)
    log(f"[smoke] phase 5 (distance kernels vs plain) "
        f"{time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    dist_paths = phase_pipeline(dev, x, grouping, f_p_main)
    log(f"[smoke] phase 6 (features path) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    rows += phase_distance_timings(dev, x, dist_paths, dist_worst)
    log(f"[smoke] phase 7 (distance timings) "
        f"{time.perf_counter() - t0:.2f}s")
    log(f"[smoke] total {time.perf_counter() - t_all:.2f}s")

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
