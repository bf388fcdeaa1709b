"""s_W implementation registry.

Twin of `repro/engine/registry.py`. Every implementation sits behind one
batch interface

    fn(mat2, groupings, inv_group_sizes) -> (n_perms,) f32 s_W

and dispatches on the device of its operands: on CPU tensors it runs its
plain `core.fstat` form, on CUDA tensors its hand-written kernel:

  brute    paper Algorithm 3        -> the brute kernel
  tiled    paper Algorithm 2        -> the permblock kernel (Algorithm 2's
                                       dataflow on an on-chip tile)
  matmul   one-hot reformulation    -> the matmul kernel

The reference's kernel names `pallas_brute`, `pallas_permblock` and
`pallas_matmul` are accepted as aliases of these three.

Dense designs (core.design: covariates, weights, several factors) need a
per-column companion, `cols(mat2, vperms (P, n, K)) -> (P, K)`: brute ->
`fstat.sw_cols_brute`, matmul -> `fstat.sw_cols_matmul`; tiled is
label-only and routes dense designs to matmul's (`resolve_cols`). The
companions are plain torch matrix products on every device; labels-mode
designs (one factor with strata) need none, since every impl consumes
permuted labels unchanged.

Row-sharded s_W (core.distributed) needs a `sharded` companion,
`sharded(mat2_rows, row_offset, groupings, inv_gs) -> (P, k)` partial
columns of a row slab: the slabs' columns concatenated in row order and
summed over the columns give s_W. brute's are its 64-row bands (the brute
kernel's row-slab entry on CUDA tensors, `fstat.sw_rows_bands` on CPU
ones), so whole-band slabs give the whole launch's bits; matmul's is one
column, `fstat.sw_matmul_rows_partial` (a torch.matmul on the card: the
reference takes this product outside any kernel too). `get_sharded` gives
tiled brute's, and `sharded_width` a slab's count of partial columns.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Mapping, Optional, Tuple

from repro_torch.core import fstat
from repro_torch.kernels.permanova_sw import ops

ALIASES = {"pallas_brute": "brute", "pallas_permblock": "tiled",
           "pallas_matmul": "matmul"}


@dataclasses.dataclass(frozen=True)
class SwImpl:
    """One s_W implementation plus the metadata the planner reads."""
    name: str
    plain: Callable               # core.fstat form, run on CPU tensors
    kernel: str                   # ops.VARIANTS entry, run on CUDA tensors
    tuning: Mapping[str, int]     # knobs of the plain form (the kernels
                                  # take their tiles from the source)
    description: str = ""
    cols: Optional[Callable] = None   # dense-design companion, or None
                                      # for a label-only dataflow
    card_bytes_per_perm: Optional[Callable[[int], int]] = None
    # device bytes the kernel's partials add per permutation at n, charged
    # by a cuda plan beside the labels (None: nothing to charge)
    sharded: Optional[Callable] = None    # row-slab partial columns

    def bound(self, **overrides) -> Callable:
        """The batch callable, with tuning resolved (defaults <-
        overrides, unknown keys dropped)."""
        kw = {k: v for k, v in {**self.tuning, **overrides}.items()
              if k in self.tuning}
        plain = functools.partial(self.plain, **kw)
        kernel = self.kernel

        def fn(mat2, groupings, inv_group_sizes):
            if mat2.device.type == "cuda":
                return ops.permanova_sw(mat2, groupings, inv_group_sizes,
                                        variant=kernel)
            return plain(mat2, groupings, inv_group_sizes)
        return fn


_REGISTRY: dict = {}


def register(impl: SwImpl) -> SwImpl:
    if impl.name in _REGISTRY:
        raise ValueError(f"duplicate s_W impl {impl.name!r}")
    _REGISTRY[impl.name] = impl
    return impl


def get(name: str) -> SwImpl:
    """The impl registered as `name` (or as its pallas_* alias)."""
    try:
        return _REGISTRY[ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(f"unknown s_W impl {name!r}; registered: "
                       f"{sorted(_REGISTRY)}, aliases: "
                       f"{sorted(ALIASES)}") from None


def names():
    """Registered impl names."""
    return sorted(_REGISTRY)


def get_sharded(name: str) -> Callable:
    """The row-sharded companion of `name` (or its alias); tiled, which
    has none, runs brute's bands (its kernel's tiles are brute's)."""
    impl = get(name)
    return impl.sharded if impl.sharded is not None \
        else get("brute").sharded


def sharded_width(name: str, n_rows: int) -> int:
    """The partial columns get_sharded(name) gives a slab of n_rows rows:
    brute's 64-row bands, matmul's one column; none for an empty slab."""
    if n_rows <= 0:
        return 0
    if get_sharded(name) is _brute_rows:
        return -(-n_rows // fstat.BAND_ROWS)
    return 1


def _brute_rows(mat2_rows, row_offset, groupings, inv_group_sizes):
    return ops.permanova_sw_rows(mat2_rows, groupings, inv_group_sizes,
                                 row_offset=row_offset)


def _matmul_rows(mat2_rows, row_offset, groupings, inv_group_sizes):
    return fstat.sw_matmul_rows_partial(mat2_rows, row_offset, groupings,
                                        inv_group_sizes)[:, None]


def resolve_cols(name: str) -> Tuple[str, Callable]:
    """(impl name, dense-design companion) for `name`, falling back to the
    matmul form when the impl is label-only (tiled)."""
    impl = get(name)
    if impl.cols is not None:
        return impl.name, impl.cols
    return "matmul", get("matmul").cols


def bound_cols(name: str, **overrides) -> Callable:
    """The dense-design companion for `name` with the resolved impl's
    tuning knobs bound (unknown keys dropped)."""
    resolved, fn = resolve_cols(name)
    kw = {k: v for k, v in overrides.items() if k in get(resolved).tuning}
    return functools.partial(fn, **kw) if kw else fn


def bound_sw(name: str, *, cols: bool = False, **overrides) -> Callable:
    """A serving bucket's s_W callable: `name`'s label-mode form with its
    tuning bound, or with `cols` its dense-design companion
    (bound_cols)."""
    if cols:
        return bound_cols(name, **overrides)
    return get(name).bound(**overrides)


register(SwImpl(
    name="brute", plain=fstat.sw_brute, kernel="brute",
    tuning={"block": 32},
    description="paper Algorithm 3 dataflow: every perm re-streams mat2 "
                "(the MI300A GPU winner)",
    cols=fstat.sw_cols_brute, sharded=_brute_rows,
))
register(SwImpl(
    name="tiled", plain=fstat.sw_tiled, kernel="permblock",
    tuning={"tile": 64, "block": 8},
    description="paper Algorithm 2 dataflow: cache-tiled loop nest (the "
                "MI300A CPU winner); on the card, every perm of a chunk "
                "per staged mat2 tile",
    card_bytes_per_perm=lambda n: 4 * ops.permblock_blocks(n),
))
register(SwImpl(
    name="matmul", plain=fstat.sw_matmul, kernel="matmul",
    tuning={"perm_block": 64},
    description="one-hot matmul reformulation (amortizes each mat2 byte "
                "over perm_block*G columns)",
    cols=fstat.sw_cols_matmul, sharded=_matmul_rows,
))
