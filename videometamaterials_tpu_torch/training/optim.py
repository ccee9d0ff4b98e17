"""The train step's optimizer: optax's adam and clip_by_global_norm, and
optax.MultiSteps around them.

torch.optim.Adam with betas (0.9, 0.999) and eps 1e-8 is optax.adam's
update (bias-corrected moments, eps outside the square root in both).
torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm, so optax's global-norm
clip is written out here. `MultiSteps` is optax 0.2.6's MultiSteps with
every_k_schedule=k and use_grad_mean=True, the JAX Trainer's gradient
accumulation (trainer.py:145-152).
"""

from __future__ import annotations

from typing import Iterable, Sequence

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


class MultiSteps:
    """optax.MultiSteps(inner, every_k_schedule=k) state and arithmetic for
    a torch optimizer: acc_grads, the running mean of the micro-batch
    gradients (Welford, acc + (g - acc) / (mini_step + 1) in float32, as
    optax rounds it); mini_step (micro-steps since the last inner step) and
    gradient_step (inner steps taken). On micro-steps 1..k-1 the inner
    chain does not run and the parameters and its state stay as they are;
    on the k-th the inner chain (clip, when set, then Adam) runs on the
    mean, and acc_grads is reset to 0 * acc_grads (optax's signed zeros)."""

    def __init__(self, params: Sequence[torch.Tensor], k: int):
        self.k = k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc_grads = [torch.zeros_like(p, dtype=torch.float32)
                          for p in params]

    @torch.no_grad()
    def accumulate(self, grads: Sequence[torch.Tensor | None]) -> bool:
        """Fold one micro-batch's gradients (None: zeros) into the mean;
        returns whether this micro-step runs the inner chain."""
        n = self.mini_step
        for acc, g in zip(self.acc_grads, grads):
            g = torch.zeros_like(acc) if g is None else g.float()
            acc.add_((g - acc) / (n + 1))
        return n == self.k - 1

    @torch.no_grad()
    def advance(self, emitted: bool) -> None:
        """The counters after a micro-step, and the reset after an inner
        step."""
        if emitted:
            torch._foreach_mul_(self.acc_grads, 0.0)
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.k
