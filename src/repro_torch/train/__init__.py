from repro_torch.train.step import (
    TrainState,
    abstract_train_state,
    init_train_state,
    loss_and_grads,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_batch,
    make_train_step,
    train_batch_shapes,
    train_state_axes,
)

__all__ = [
    "TrainState",
    "abstract_train_state",
    "init_train_state",
    "loss_and_grads",
    "loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_batch",
    "make_train_step",
    "train_batch_shapes",
    "train_state_axes",
]
