"""Config registry of the port.  This slice registers the paper's two models
(``paper_models.py``); the assigned architectures come with later slices."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register  # noqa
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, get_shape, LONG_CONTEXT_WINDOW  # noqa
from repro_torch.configs import paper_models  # noqa: F401  (registers)

PAPER_MODELS = ("gte-base-en-v1.5", "sheared-llama-2.7b")
