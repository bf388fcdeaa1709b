from repro_torch.train.step import (  # noqa: F401
    TrainState,
    make_train_step,
    make_train_state_init,
    default_optimizer_for,
)
