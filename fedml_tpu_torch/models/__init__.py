"""Model zoo, port of fedml_tpu/models: the main path's CNNOriginalFedAvg and
LogisticRegression, and the long-context TransformerLM; ``create_model``
names the ROADMAP.md queue of every other model."""

from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
from fedml_tpu_torch.models.factory import create_model
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.transformer import TransformerLM

__all__ = ["CNNOriginalFedAvg", "LogisticRegression", "TransformerLM",
           "create_model"]
