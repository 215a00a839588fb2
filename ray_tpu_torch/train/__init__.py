"""ray_tpu_torch.train — language-model training, and the training gang
(reference: Ray Train).

Usage inside train_loop_per_worker:

    from ray_tpu_torch import train

    def train_func(config):
        ctx = train.get_context()
        ckpt = train.get_checkpoint()            # set after a gang restart
        it = train.get_dataset_shard("train").iter_device_batches(batch_size=4)
        ...
        train.report({"loss": loss}, checkpoint=train.Checkpoint(path))

`lm` trains the decoder on one device. The gang (`TorchTrainer`, its
configs, session, checkpoints) is the port's copy of ray_tpu/train on the
thread-mode runtime, with the logger callbacks (`integrations.py`:
MLflowLoggerCallback, WandbLoggerCallback, in their local-file layout when
the client library is absent). The pipeline trainer (`train/pipeline.py`)
waits for ROADMAP A7b.
"""

from .checkpoint import (  # noqa: F401
    AsyncCheckpointWriter,
    Checkpoint,
    CheckpointManager,
    broadcast_checkpoint,
    load_pytree,
    restore_checkpoint,
    save_pytree,
)
from .config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .integrations import MLflowLoggerCallback, WandbLoggerCallback  # noqa: F401
from .lm import (  # noqa: F401
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    synthetic_batch,
)
from .result import Result  # noqa: F401
from .session import (  # noqa: F401
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from .trainer import TorchTrainer, TrainingFailedError  # noqa: F401

_WAITING = {
    "DEFAULT_STAGE_RULES": "the pipeline trainer (train/pipeline.py) waits for ROADMAP A7b",
    "LMStageModule": "the pipeline trainer (train/pipeline.py) waits for ROADMAP A7b",
    "PipelineConfig": "the pipeline trainer (train/pipeline.py) waits for ROADMAP A7b",
    "PipelineStallError": "the pipeline trainer (train/pipeline.py) waits for ROADMAP A7b",
    "PipelineTrainer": "the pipeline trainer (train/pipeline.py) waits for ROADMAP A7b",
    "match_stage_rules": "the pipeline trainer (train/pipeline.py) waits for ROADMAP A7b",
    "split_stage_params": "the pipeline trainer (train/pipeline.py) waits for ROADMAP A7b",
}


def __getattr__(name):
    if name in _WAITING:
        raise NotImplementedError(f"ray_tpu_torch.train.{name}: {_WAITING[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
