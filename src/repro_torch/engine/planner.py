"""Hardware-aware planner for the s_W registry.

Twin of `repro/engine/planner.py`. The heuristics encode the paper's
Figure 1 result as dispatch rules:

  backend   choice                       why
  -------   -------------------------   -------------------------------------
  cuda      brute                       the paper's GPU cores prefer the
                                        brute Algorithm 3
  cpu       tiled  (mat2 > LLC)         CPU cores want the cache-tiled
            matmul (mat2 fits cache)    Algorithm 2 once the matrix spills
                                        the last-level cache; below that
                                        the one-hot BLAS form wins

`plan()` is shape/backend arithmetic only, no timing; it also fixes the
streaming chunk, so the live label tensor is (chunk, n) int32 rather
than (n_perms, n). On cuda a kernel whose partials grow with the chunk
(the permblock kernel's (blocks, chunk)) has them charged beside the
labels; cpu plans match the reference's. Dense designs (`n_cols` = K
basis columns) plan a per-column companion instead
(registry.resolve_cols): brute on cuda, matmul on cpu, both plain torch
products, with the chunk sized for the (chunk, n, K) basis factor. (The reference's measured autotune and its
persisted cache are not ported yet.)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

from repro_torch.engine import registry

# Model constants (bytes). LLC: an MI300A CCD carries 32 MiB L3; once mat2
# spills it the paper's tiled dataflow wins on CPU.
CPU_LLC_BYTES = 32 * 1024 ** 2
DEFAULT_STREAM_BUDGET_BYTES = 256 * 1024 ** 2
MIN_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """A resolved execution plan for one PERMANOVA problem."""
    impl: str                 # registry name
    backend: str              # 'cuda' | 'cpu'
    tuning: Dict[str, int]    # the plain form's knobs (SwImpl.bound);
                              # empty on cuda, where the kernel runs
    kernel: Optional[str]     # the kernel that runs on cuda, else None
    chunk: int                # permutations per scheduler dispatch
    streaming: bool           # True when n_perms+1 > chunk
    reason: str

    def describe(self) -> str:
        t = f"{self.kernel} kernel" if self.kernel else ",".join(
            f"{k}={v}" for k, v in sorted(self.tuning.items()))
        mode = f"stream(chunk={self.chunk})" if self.streaming else "batch"
        return f"{self.impl}[{t}] {mode} on {self.backend}: {self.reason}"


def _pick_impl(backend: str, n: int) -> Tuple[str, str]:
    if backend == "cuda":
        return "brute", "GPU cores prefer brute force (paper Fig. 1)"
    mat2_bytes = 4 * n * n
    if backend == "cpu" and mat2_bytes > CPU_LLC_BYTES:
        return "tiled", (f"mat2 {mat2_bytes/2**20:.0f}MiB spills the "
                         f"{CPU_LLC_BYTES/2**20:.0f}MiB LLC; cache-tiled "
                         "Algorithm 2 wins on CPU (paper Fig. 1)")
    return "matmul", "mat2 cache-resident; one-hot BLAS form amortizes reads"


def _pick_impl_design(backend: str) -> Tuple[str, str]:
    """Impl for DENSE designs: the re-streaming brute dataflow on the card
    (the paper's Fig. 1 GPU rule), the per-column matmul form elsewhere."""
    if backend == "cuda":
        return "brute", ("dense design, GPU: per-perm re-stream "
                         "(Fig. 1 brute analogue)")
    return "matmul", ("dense design: per-column matmul contraction "
                      "(hat-matrix blocks on the MXU/BLAS path)")


def label_budget(budget_bytes: Optional[float] = None) -> float:
    """The label budget in bytes: the caller's, or the default."""
    return DEFAULT_STREAM_BUDGET_BYTES if budget_bytes is None \
        else budget_bytes


def chunk_for_budget(n: int, n_perms: int,
                     budget_bytes: Optional[float] = None,
                     n_cols: Optional[int] = None,
                     partial_bytes_per_perm: float = 0.0) -> int:
    """Largest permutation chunk whose streamed state — (chunk, n) int32
    labels plus the per-perm output — fits the budget. The resident mat2
    is paid regardless of chunking and is not charged against it. Dense
    designs (n_cols = K basis columns) also stream the gathered (chunk, n,
    K) f32 basis factor and a (chunk, K) output. partial_bytes_per_perm:
    a kernel's partials per permutation (SwImpl.card_bytes_per_perm),
    charged beside the labels."""
    budget = label_budget(budget_bytes)
    per_perm = 4.0 * n + 8.0 + partial_bytes_per_perm
    if n_cols is not None:
        per_perm += 4.0 * n * n_cols + 4.0 * n_cols
    if MIN_CHUNK * per_perm > budget:
        warnings.warn(
            f"label budget {budget/2**20:.2f}MiB cannot hold even the "
            f"minimum chunk ({MIN_CHUNK} perms x {4*n} label bytes) at "
            f"n={n}; proceeding with chunk={MIN_CHUNK} — label memory will "
            "exceed the budget", stacklevel=2)
        return min(MIN_CHUNK, n_perms)
    return min(max(MIN_CHUNK, int(budget // per_perm)), n_perms)


def plan(n: int, n_perms: int, *, backend: str,
         memory_budget_bytes: Optional[float] = None,
         chunk: Optional[int] = None, impl: Optional[str] = None,
         n_cols: Optional[int] = None) -> Plan:
    """Resolve impl + streaming chunk for one problem.

    n_perms counts all permutation slots (the requested count + 1 for the
    observed labels at index 0). `impl`/`chunk` pin those choices.
    n_cols: the basis width K of a DENSE design; the plan then names the
    impl whose per-column companion runs (a label-only impl resolves to
    matmul's) and no kernel, since the companions are torch products.
    """
    if impl is None:
        name, reason = (_pick_impl_design(backend) if n_cols is not None
                        else _pick_impl(backend, n))
    else:
        name, reason = impl, "caller-pinned impl"
    if n_cols is not None:
        resolved, _ = registry.resolve_cols(name)
        if resolved != registry.get(name).name:
            reason += (f"; {name!r} is label-only, dense design runs its "
                       f"{resolved!r} companion")
            name = resolved
    spec = registry.get(name)
    on_card = backend == "cuda" and n_cols is None
    if chunk is None:
        partials = spec.card_bytes_per_perm(n) \
            if on_card and spec.card_bytes_per_perm else 0.0
        chunk = chunk_for_budget(n, n_perms, memory_budget_bytes,
                                 n_cols=n_cols,
                                 partial_bytes_per_perm=partials)
    chunk = max(1, min(int(chunk), n_perms))
    return Plan(impl=spec.name, backend=backend,
                tuning={} if on_card else dict(spec.tuning),
                kernel=spec.kernel if on_card else None,
                chunk=chunk, streaming=chunk < n_perms, reason=reason)
