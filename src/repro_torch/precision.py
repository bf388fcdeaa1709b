"""The fp8 (e4m3) cast shared by the distance core and the LM modules.

torch's cast to float8_e4m3fn saturates to +-448; the reference's cast
(ml_dtypes, round to nearest even) gives NaN past the range.
`fp8_quantize` casts as the reference does, so both the PERMANOVA feature
slabs (`core.distance`) and the LM's fp8 KV caches (`models.nn.cast`)
hold the reference's bytes.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0            # largest finite float8_e4m3fn magnitude
# Past this |x| / scale the reference's cast (ml_dtypes, round to nearest
# even) gives NaN, while torch's saturates to +-448; 464 itself, the
# midpoint to the next (absent) step, still rounds to 448.
FP8_NAN_ABOVE = 464.0


def fp8_quantize(xprep, scale) -> torch.Tensor:
    """x / scale cast to float8_e4m3fn, byte for byte the reference's cast:
    round to nearest even, and NaN (with x's sign) where |x| / scale >
    FP8_NAN_ABOVE, where torch alone would saturate to +-448."""
    x = torch.as_tensor(xprep, dtype=torch.float32)
    y = x / torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    y = torch.where(y.abs() > FP8_NAN_ABOVE,
                    torch.copysign(torch.full_like(y, float("nan")), y), y)
    return y.to(torch.float8_e4m3fn)
