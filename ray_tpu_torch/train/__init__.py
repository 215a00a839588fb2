"""ray_tpu_torch.train — language-model training on one device."""

from .lm import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    synthetic_batch,
)
