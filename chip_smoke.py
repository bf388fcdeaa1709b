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
    import torch
    from repro_torch.kernels.permanova_sw import ops
    log(f"[smoke] card: {card_line()}")
    log(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = ops.load_library()
    log(f"[smoke] kernel build+load {time.perf_counter() - t0:.2f}s "
        f"({ops.SOURCE.name} -> {ops._build.library_path(ops.SOURCE).name}) "
        f"config {ops.kernel_config(lib)}")


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
    from repro_torch.kernels.permanova_sw import ops
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0


def phase_main_path(dev):
    """The paper's EMP shape through the entry points a user calls. Returns
    mat2, the labels' device copy and each run's own launch counts."""
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
    return mat2, g_dev, paths


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
        library_ms = None
        if v == "matmul":
            e = fstat.onehot_perm_factors(labels, inv_gs, mat2.dtype)
            e2d = e.permute(1, 0, 2).reshape(EMP_N, -1).contiguous()
            library_ms = cuda_ms(lambda: torch.matmul(mat2, e2d), reps=3)
            del e, e2d
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
    mat2, g_dev, paths = phase_main_path(dev)
    log(f"[smoke] phase 3 (EMP main path) {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    rows = phase_timings(dev, mat2, g_dev, paths, worst)
    del mat2
    phase_reference(dev)
    log(f"[smoke] phase 4 (timings, reference) "
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
