"""Hand-written CUDA C++ kernels for Hopper (sm_90a), each beside its plain
PyTorch version (`ref.py`) and a wrapper (`ops.py`) that launches the
kernel on CUDA tensors and runs the plain version on CPU tensors."""


class ShapeNotSupported(ValueError):
    """A kernel does not apply to this shape: its grid or its partial sum
    cannot cover it. The one launch error an autotune shoot-out skips a
    candidate for; every other build or launch error propagates."""


def tile_visit_elems(nr: int, n: int, tile: int, symmetric: bool):
    """(visits, column elements, row elements) of a kernel's walk over
    (tile x tile) tiles of an (nr, n) operand: every (row tile, column
    tile) pair, or for a symmetric whole-table call (nr == n) the pairs
    j >= i. The element counts sum, over the visited tiles, the tile's
    columns below n and its rows below nr: what a kernel reads per
    permutation (or feature) when it loads a tile's column and row
    labels (or features) at each visit, masking what lies past the edge.
    The traffic models of the kernels' launches (`launch_bytes`) are
    built on it."""
    nti, ntj = -(-nr // tile), -(-n // tile)

    def width(t, m):
        return min(tile, m - t * tile)
    if symmetric:
        if nr != n:
            raise ValueError("a symmetric call covers an (n, n) operand")
        visits = nti * (nti + 1) // 2
        cols = sum(width(j, n) * (j + 1) for j in range(ntj))
        rows = sum(width(i, nr) * (nti - i) for i in range(nti))
    else:
        visits = nti * ntj
        cols, rows = n * nti, nr * ntj
    return visits, cols, rows
