"""Serving (twin of `repro.serve`): the always-on PERMANOVA service, and
the LM decode loop with continuous batching (`serve/engine.py`).
"""

from repro_torch.serve.permanova import (  # noqa: F401
    PermanovaServer,
    RetryPolicy,
    ServeResult,
    ServerOverloaded,
    StudyRequest,
    mc_pvalue_ci,
    serve_stats_from_events,
)
