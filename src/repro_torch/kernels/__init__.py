"""Hand-written Hopper kernels of the tick's hot path (``csrc/*.cu``), their
plain PyTorch versions (``ref``) and the device dispatch (``ops``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
