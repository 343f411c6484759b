"""Model zoo, port of fedml_tpu/models: the main path's CNNOriginalFedAvg and
LogisticRegression, CNNDropOut, the CIFAR ResNets (ResNetCIFAR with
BatchNorm, GroupNorm or Fixup blocks; ResNet18GN), and the long-context
TransformerLM; ``create_model`` names the ROADMAP.md queue of every other
model."""

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg
from fedml_tpu_torch.models.factory import create_model
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.resnet import ResNetCIFAR
from fedml_tpu_torch.models.resnet_gn import ResNet18GN
from fedml_tpu_torch.models.transformer import TransformerLM

__all__ = ["CNNDropOut", "CNNOriginalFedAvg", "LogisticRegression",
           "ResNet18GN", "ResNetCIFAR", "TransformerLM", "create_model"]
