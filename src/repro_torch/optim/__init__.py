from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    adafactor,
    sgdm,
    clip_by_global_norm,
)
from repro_torch.optim.schedules import warmup_cosine, constant  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compress_int8,
    decompress_int8,
    ErrorFeedbackState,
    error_feedback_compress,
    init_error_feedback,
    allreduce_compressed,
)
from repro_torch.optim.optimizers import apply_updates  # noqa: F401
