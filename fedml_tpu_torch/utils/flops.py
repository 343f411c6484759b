"""Model-FLOPs accounting for MFU reporting, port of fedml_tpu/utils/flops.py.

The reference asks XLA for the compiled forward's ``cost_analysis()``;
eager PyTorch compiles no program, so this module counts with
``torch.utils.flop_counter.FlopCounterMode`` instead: one forward of the
task's module on the ``meta`` device (nothing is allocated, nothing runs)
under ``torch.no_grad()``. Train-step FLOPs use the reference's 3x-forward
accounting (forward + two backward matmul passes).

Two conventions differ from the reference's count, and both are pinned by
tests:

- **No grad.** The port's CNN routes conv2's weight gradient through an
  exactly-zero ``einsum`` term when grad is enabled (models/cnn.py
  ``conv2d``); counted under grad it would add ~20 GFLOP of bookkeeping a
  sample (44,669,952 against 24,599,552 for ``CNNOriginalFedAvg``). The
  count runs the plain ``F.conv2d`` branch, the model's own work.
- **Every tap counts.** FlopCounterMode charges a convolution
  2 x N x C_out x H_out x W_out x C_in x kh x kw, taps in the zero padding
  included; XLA leaves out the taps that fall in the padding. For
  ``CNNOriginalFedAvg`` the port counts 24,599,552 FLOPs a sample (conv1
  1,254,400 + conv2 20,070,400 + fc1 3,211,264 + fc2 63,488), XLA's
  ``compiled_flops`` of the same forward 21,277,502: x1.156.

MFU is quoted against the card's dense bf16 peak
(obs/goodput.PEAK_FLOPS_BF16, looked up by device_peak_flops there), the
reference's convention: float32 runs still quote the bf16 peak
(conservative — the port's f32 fits run on CUDA cores and cuDNN, far
below it).
"""

from __future__ import annotations

import logging

log = logging.getLogger("fedml_tpu_torch.utils.flops")


def forward_flops(task, net: dict, x_sample) -> float | None:
    """FLOPs of one forward of ``task``'s module on ONE sample shaped like
    ``x_sample[0]`` (its dtype kept: the task's own input path runs, e.g.
    uint8 pixels -> f32/255), counted on the ``meta`` device under
    ``torch.no_grad()``. ``net`` supplies the parameter shapes. None when
    the module cannot be traced on ``meta`` (a hand kernel's wrapper, say).
    Never raises — MFU is garnish."""
    try:
        import torch
        from torch.utils.flop_counter import FlopCounterMode

        meta = {k: torch.empty_like(v, device="meta") for k, v in net.items()}
        x = torch.empty((1,) + tuple(x_sample.shape[1:]),
                        dtype=torch.as_tensor(x_sample[:1]).dtype,
                        device="meta")
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), counter:
            task.predict(meta, x)
        f = float(counter.get_total_flops())
        return f if f > 0 else None
    except Exception:  # noqa: BLE001
        log.debug("forward FLOP count failed", exc_info=True)
        return None
