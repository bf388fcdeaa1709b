"""Wall-clock timing helpers (twin of `repro/utils/timing.py`).

Where the reference waits with `jax.block_until_ready`, `time_fn` waits
for the CUDA devices of the output's tensors (`torch.cuda.synchronize`);
a CPU output has nothing to wait for. The numbers are host-clock times of
completed work on the device the output lives on.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from repro_torch.utils.tree import tree_leaves


class Timer:
    """Context-manager timer; .elapsed in seconds."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Repeat-measurement summary from `time_fn`.

    Floats coerce to the median, so `float(time_fn(...))` and arithmetic
    via .median keep their meaning.
    """
    median: float
    min: float
    mean: float
    std: float
    n: int
    trimmed: int = 0

    def __float__(self) -> float:
        return self.median


def _block_until_ready(out):
    """Wait for every CUDA device that holds a tensor of `out` (a tree);
    returns `out`."""
    devices = {x.device for x in tree_leaves(out)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def time_fn(fn, *args, iters: int = 5, warmup: int = 2, trim: int = 0,
            **kwargs) -> TimingStats:
    """Time fn(*args), waited for, over `iters` repeats.

    trim: drop the `trim` slowest AND `trim` fastest measurements before
    summarizing (symmetric trim — robust to scheduler noise on shared
    hosts). Requires iters > 2*trim.

    Returns TimingStats; use `.median` (or float()) where a scalar is
    needed.
    """
    if iters <= 2 * trim:
        raise ValueError(f"iters={iters} must exceed 2*trim={2 * trim}")
    for _ in range(warmup):
        _block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    kept = times[trim: len(times) - trim] if trim else times
    return TimingStats(
        median=statistics.median(kept),
        min=kept[0],
        mean=statistics.fmean(kept),
        std=statistics.pstdev(kept) if len(kept) > 1 else 0.0,
        n=len(kept),
        trimmed=trim,
    )
