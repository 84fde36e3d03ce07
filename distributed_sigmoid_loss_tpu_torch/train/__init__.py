from distributed_sigmoid_loss_tpu_torch.train.ema import (  # noqa: F401
    ema_decay_schedule,
    init_ema,
    update_ema,
)
from distributed_sigmoid_loss_tpu_torch.train.train_step import (  # noqa: F401
    Adafactor,
    AdamW,
    Lion,
    TrainState,
    accum_add,
    accum_finish,
    accum_zeros,
    create_train_state,
    make_optimizer,
    make_functional_train_step,
    make_schedule,
    make_train_step,
    run_gradcache,
    train_state_tree,
    validate_accum_args,
    validate_step_args,
)
from distributed_sigmoid_loss_tpu_torch.train.checkpoint import (  # noqa: F401
    AsyncSaver,
    restore_checkpoint,
    save_checkpoint,
)
from distributed_sigmoid_loss_tpu_torch.train.resilience import (  # noqa: F401
    PreemptionGuard,
    ResilienceReport,
    RestoreRequiredError,
    TrainingDiverged,
    latest_step,
    restore_latest,
    save_step,
    train_resilient,
)
from distributed_sigmoid_loss_tpu_torch.train.export import (  # noqa: F401
    ExportedStep,
    FlatProgram,
    export_step,
    load_exported,
    load_forward,
    save_exported,
    tree_leaves,
)
