"""The train step's optimizer: optax's adam and clip_by_global_norm.

torch.optim.Adam with betas (0.9, 0.999) and eps 1e-8 is optax.adam's
update (bias-corrected moments, eps outside the square root in both).
torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm, so optax's global-norm
clip is written out here.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient becomes
    (g / norm) * max_norm unless the global norm is below max_norm. Returns
    the norm. Decided on the device (no host sync)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm
