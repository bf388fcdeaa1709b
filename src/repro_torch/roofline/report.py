"""Table rendering shared with obs.report.

Twin of `render_table` in `repro/roofline/report.py`. The rest of that
module renders the dry-run tables of compiled XLA programs, which have no
counterpart in the port.
"""

from __future__ import annotations


def render_table(headers, rows):
    """Generic column-aligned markdown table (shared with obs.report)."""
    cells = [list(map(str, headers))] + [list(map(str, r)) for r in rows]
    widths = [max(len(row[i]) for row in cells)
              for i in range(len(headers))]

    def fmt(row):
        return "| " + " | ".join(c.ljust(w)
                                 for c, w in zip(row, widths)) + " |"
    sep = "|" + "|".join("-" * (w + 2) for w in widths) + "|"
    return "\n".join([fmt(cells[0]), sep] + [fmt(r) for r in cells[1:]])
