"""Training side of the port: the SSL model and train step, train state, loop, CLI."""

from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.ssl import SSLModel, SSLModelConfig, init_ssl_model, make_ssl_train_step, params_from_jax
from repro_torch.train.train_state import TrainState, create_train_state
