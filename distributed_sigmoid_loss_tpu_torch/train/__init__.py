from distributed_sigmoid_loss_tpu_torch.train.train_step import (  # noqa: F401
    AdamW,
    TrainState,
    accum_add,
    accum_finish,
    accum_zeros,
    create_train_state,
    make_optimizer,
    make_schedule,
    make_train_step,
    validate_accum_args,
    validate_step_args,
)
