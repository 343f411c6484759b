"""fedml_tpu_torch — the PyTorch / CUDA port of fedml_tpu for NVIDIA Hopper.

A package of its own beside ``fedml_tpu`` (the JAX reference, which it never
imports). Module names mirror the reference's, so each counterpart is found
under the same path. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; see ``fedml_tpu_torch.device``.
"""
