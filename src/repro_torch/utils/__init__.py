from repro_torch.utils.tree import (  # noqa: F401
    tree_bytes,
    tree_count,
    tree_norm,
    tree_zeros_like,
    tree_cast,
)
from repro_torch.utils.timing import Timer, TimingStats, time_fn  # noqa: F401
