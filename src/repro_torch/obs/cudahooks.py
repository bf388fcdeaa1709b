"""Card-side hooks feeding the MetricsRegistry.

Twin of `repro/obs/jaxhooks.py`. Where the reference counts jit retraces
and XLA compiles through `jax.monitoring`, the port's compile step is
`kernels/_build.build`: every nvcc run counts one `cuda.builds` and
observes its seconds in the histogram `cuda.build_seconds`; a library
found already built counts one `cuda.loads`. Each kernel family's launch
site (`kernels/*/ops.py`, beside its `LAUNCHES` count) adds one to
`cuda.launches.<key>`, with LAUNCHES' keys. `record_device_memory()`
gauges each card's peak allocated bytes. All of it is inert while
metrics are disabled.
"""

from __future__ import annotations

from repro_torch.obs import metrics as _metrics

BUILDS = "cuda.builds"
BUILD_SECONDS = "cuda.build_seconds"
LOADS = "cuda.loads"
LAUNCH_PREFIX = "cuda.launches."


def count_build(seconds: float) -> None:
    """One nvcc build of a kernel library, and how long it took."""
    _metrics.inc(BUILDS)
    _metrics.observe(BUILD_SECONDS, seconds)


def count_load() -> None:
    """One kernel library found already built."""
    _metrics.inc(LOADS)


def count_launch(key: str) -> None:
    """One kernel launch under its LAUNCHES key (no string is built while
    metrics are off)."""
    if _metrics.active():
        _metrics.inc(LAUNCH_PREFIX + key)


def launch_counts(snapshot: dict) -> dict:
    """{LAUNCHES key: count} from a metrics snapshot's counters."""
    n = len(LAUNCH_PREFIX)
    return {k[n:]: v for k, v in (snapshot.get("counters") or {}).items()
            if k.startswith(LAUNCH_PREFIX)}


def record_device_memory() -> None:
    """Gauge each initialised card's peak allocated bytes
    (`torch.cuda.max_memory_allocated`) as `device{i}.peak_bytes_in_use`;
    nothing on a host without CUDA, as the reference skips the CPU."""
    if not _metrics.active():
        return
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    for i in range(torch.cuda.device_count()):
        _metrics.gauge_set(f"device{i}.peak_bytes_in_use",
                           float(torch.cuda.max_memory_allocated(i)))
