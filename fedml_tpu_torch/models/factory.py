"""Model factory, port of fedml_tpu/models/factory.py.

Ported: ``lr``, ``cnn`` and the long-context models; every other reference
name raises and names its ROADMAP.md queue.
"""

from __future__ import annotations

from fedml_tpu_torch.device import resolve_device

_QUEUED = {
    "cnn_dropout": "A, item 3",
    "rnn": "A, item 10", "rnn_stackoverflow": "A, item 10",
    "resnet56": "A, item 10", "resnet110": "A, item 10",
    "resnet_wo_bn": "A, item 10", "resnet56_wo_bn": "A, item 10",
    "resnet18_gn": "A, item 10", "mobilenet": "A, item 10",
    "mobilenet_v3": "A, item 10", "mobilenet_v3_large": "A, item 10",
    "efficientnet": "A, item 10", "vgg11": "A, item 10", "vgg16": "A, item 10",
    "darts": "A, item 9", "darts_cifar": "A, item 9",
    "darts_imagenet": "A, item 9",
}


def create_model(model_name: str, output_dim: int = 10, device=None,
                 **kwargs):
    """Return the torch module for a reference model name, on ``device``
    (the CUDA device when None; see fedml_tpu_torch.device)."""
    name = model_name.lower()
    if name == "lr":
        from fedml_tpu_torch.models.linear import LogisticRegression

        return LogisticRegression(num_classes=output_dim).to(
            resolve_device(device))
    if name == "cnn":
        from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg

        return CNNOriginalFedAvg(only_digits=(output_dim == 10)).to(
            resolve_device(device))
    if name in ("transformer", "transformer_flash"):
        from fedml_tpu_torch.models.transformer import TransformerLM

        kwargs.setdefault("use_flash", name == "transformer_flash")
        kwargs.setdefault("vocab_size", output_dim)
        return TransformerLM(**kwargs).to(resolve_device(device))
    if name in _QUEUED:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet: ROADMAP.md queue "
            f"{_QUEUED[name]}")
    raise ValueError(f"unknown model: {model_name}")
