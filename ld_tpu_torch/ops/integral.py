"""Distribution -> scalar decode for GFL distributional box regression
(port of `ld_tpu/ops/integral.py`): softmax over (reg_max+1) bins dotted with
0..reg_max, per box side."""
from __future__ import annotations

import torch


def integral(x: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Decode distribution logits to expected distances.

    Args:
        x: (..., 4*(reg_max+1)) distribution logits.
    Returns:
        (..., 4) expected (l, t, r, b) distances in bin units.
    """
    bins = reg_max + 1
    prob = torch.softmax(x.reshape(*x.shape[:-1], 4, bins), dim=-1)
    project = torch.arange(bins, dtype=prob.dtype, device=prob.device)
    return (prob * project).sum(dim=-1)
