"""Model zoo, port of fedml_tpu/models. This slice carries TransformerLM;
``create_model`` names the ROADMAP.md queue of every other model."""

from fedml_tpu_torch.models.factory import create_model
from fedml_tpu_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM", "create_model"]
