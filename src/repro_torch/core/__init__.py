"""PERMANOVA statistics in PyTorch (twin of `repro.core`).

  permanova(dm, grouping, ...)         single-device full test
  fstat.sw_{brute,tiled,matmul}        the paper's hot-loop forms
  distance.distance_matrix(x, metric)  input construction
  permutations.permutation_batch       counter-based label source
"""

from repro_torch.core import distance, fstat, permutations  # noqa: F401
from repro_torch.core.permanova import (PermanovaResult,  # noqa: F401
                                        f_from_sw, p_value_from_null,
                                        permanova, s_total)
