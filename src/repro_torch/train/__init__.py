"""Training entry points of the port: the LM train step and trainer
(ports of :mod:`repro.train`), and the neural receivers' trainer
(:mod:`repro_torch.train.neural_receiver`)."""
from repro_torch.train.step import (
    make_train_step,
    make_loss_fn,
    init_state,
    chunked_cross_entropy,
)
from repro_torch.train.trainer import Trainer
