from repro_torch.train import steps
from repro_torch.train.steps import make_serve_steps

__all__ = ["steps", "make_serve_steps"]
