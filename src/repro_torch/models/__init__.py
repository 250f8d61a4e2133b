from repro_torch.models import (attention, common, convert, mlp, model_zoo, recurrent, ssm,
                                transformer)
from repro_torch.models.model_zoo import Model, build_model, cross_entropy

__all__ = [
    "attention", "common", "convert", "mlp", "model_zoo", "recurrent", "ssm", "transformer",
    "Model", "build_model", "cross_entropy",
]
