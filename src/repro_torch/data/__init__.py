"""Training data of the port's LM scaffold."""
from repro_torch.data.pipeline import SyntheticLM, to_device

__all__ = ["SyntheticLM", "to_device"]
