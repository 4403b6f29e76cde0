"""Model configurations: the ``ModelConfig`` schema and the registry of the
reference's eleven architectures."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs

__all__ = ["ModelConfig", "get_config", "list_archs"]
