from repro_torch.train import optimizer, steps
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_opt_state, opt_state_axes
from repro_torch.train.steps import TrainConfig, init_train_state, make_serve_steps, make_train_step

__all__ = [
    "optimizer", "steps", "AdamWConfig", "apply_updates", "init_opt_state",
    "opt_state_axes", "TrainConfig", "init_train_state", "make_serve_steps",
    "make_train_step",
]
