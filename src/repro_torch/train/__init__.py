"""Step builders of the port: training and serving."""

from .step import (TrainState, loss_and_grads, make_compressed_dp_grads, make_prefill_step,
                   make_serve_step, make_train_step)

__all__ = ["TrainState", "loss_and_grads", "make_compressed_dp_grads", "make_prefill_step",
           "make_serve_step", "make_train_step"]
