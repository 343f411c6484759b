"""State-dict utilities, port of fedml_tpu/utils."""

from fedml_tpu_torch.utils.tree import (
    tree_unvectorize,
    tree_vectorize,
    tree_weighted_mean,
)

__all__ = ["tree_unvectorize", "tree_vectorize", "tree_weighted_mean"]
