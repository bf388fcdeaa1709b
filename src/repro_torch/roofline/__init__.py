"""roofline/ — the port's share of the reference's roofline package: the
markdown table helper obs.report renders through (report.render_table)."""
