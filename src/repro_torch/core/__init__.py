"""PERMANOVA statistics in PyTorch (twin of `repro.core`).

  permanova(dm, grouping, ...)         single-device full test
  fstat.sw_{brute,tiled,matmul}        the paper's hot-loop forms
  distance.distance_matrix(x, metric)  input construction
  permutations.permutation_batch       counter-based label source
  design.build / Design                covariates, strata, weights
  fstat.sw_cols_*                      the designs' per-column forms
  permanova_distributed(mesh, dm, ...) sharded over (pod, data, model)
"""

from repro_torch.core import (design, distance,  # noqa: F401
                              distributed, fstat, permutations)
from repro_torch.core.permanova import (PermanovaResult,  # noqa: F401
                                        TermResult, f_from_sw,
                                        p_value_from_null, permanova,
                                        s_total)
from repro_torch.core.distributed import (  # noqa: F401
    permanova_distributed, sw_distributed)
