"""BSQ and plain training of the port: train steps and the trainer loop."""
from .step import (  # noqa: F401
    BSQTrainContext,
    abstract_bsq_state,
    abstract_plain_state,
    bsq_loss,
    init_bsq_state,
    init_plain_state,
    make_bsq_train_step,
    make_compressed_bsq_dp_step,
    make_compressed_dp_step,
    make_plain_train_step,
    make_requant_step,
    state_reps,
    state_scheme,
)
from .trainer import StragglerMonitor, TrainerConfig, simple_train_loop, train_bsq  # noqa: F401
