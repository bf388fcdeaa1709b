"""Serving (twin of `repro.serve`): the always-on PERMANOVA service.

The reference's LM decode loop (`serve/engine.py`) belongs to the LM
scaffold and is not ported here.
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
