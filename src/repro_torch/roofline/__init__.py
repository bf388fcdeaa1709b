"""roofline/ — the dry-run's roofline terms (analysis), its op-by-op
counts of a step on fake shards (op_cost, twin of the reference's
hlo_cost) and the tables (report; its render_table is shared with
obs.report)."""

from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineTerms,
    analyze_cell,
    model_flops,
)
