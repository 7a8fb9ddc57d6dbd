"""Optimizer: per-tensor gradient normalization, then Adam under a
MultiStep learning-rate schedule — the port's copy of
``vsnca_tpu/train/optim.py`` (an optax chain there).

optax's ``adam`` and ``torch.optim.Adam`` apply one formula,
p -= lr * m̂ / (sqrt(v̂) + eps) with bias-corrected moments, at the same
defaults (β 0.9 / 0.999, eps 1e-8); ``piecewise_constant_schedule`` with
scale γ at each boundary equals ``MultiStepLR(milestones, γ)`` stepped once
per update (the update with 0-based index k uses γ^#{boundaries ≤ k}).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _normalize(g: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return g / (torch.linalg.vector_norm(g) + eps)


def normalize_grads(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """L2-normalize each parameter tensor's gradient independently."""
    return {k: _normalize(g) for k, g in grads.items()}


def multistep_lr(optimizer: torch.optim.Optimizer, boundaries: Sequence[int],
                 gamma: float) -> torch.optim.lr_scheduler.MultiStepLR:
    """The schedule: the learning rate times ``gamma`` at each boundary."""
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, [int(b) for b in boundaries],
                                                gamma)


class NormalizedAdam:
    """grad-normalize → Adam(schedule), over a dict of leaf tensors.
    ``step()`` takes the gradients in ``.grad`` (left by ``backward``).
    ``eps`` is the normalization's: 1e-8 for DyNCA, 1e-10 for the encoder
    trainer (conditioned_trainer.py:136 of the reference); Adam's own eps
    stays 1e-8."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 boundaries: Sequence[int] = (), gamma: float = 0.5, eps: float = 1e-8):
        self.params = params
        self.eps = eps
        self.adam = torch.optim.Adam(list(params.values()), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        self.schedule = multistep_lr(self.adam, boundaries, gamma) if boundaries else None

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params.values():
            if p.grad is not None:
                p.grad = _normalize(p.grad, self.eps)
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()

    @property
    def lr(self) -> float:
        return self.adam.param_groups[0]["lr"]

    def state_arrays(self) -> dict:
        """Adam's state as numpy arrays: ``{"count": updates taken, "mu":
        {name: first moment}, "nu": {name: second moment}}``, the fields of
        optax's ``ScaleByAdamState`` (zeros before the first update)."""
        mu, nu, count = {}, {}, 0
        for name, p in self.params.items():
            st = self.adam.state.get(p)
            if st:
                count = int(st["step"])
            mu[name] = (st["exp_avg"] if st else torch.zeros_like(p)).detach().cpu().numpy()
            nu[name] = (st["exp_avg_sq"] if st else torch.zeros_like(p)).detach().cpu().numpy()
        return {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


def make_optimizer(params: Dict[str, torch.Tensor], lr: float,
                   boundaries: Sequence[int] = (), gamma: float = 0.5,
                   eps: float = 1e-8) -> NormalizedAdam:
    """grad-normalize (``eps``) → Adam(lr, MultiStepLR(boundaries, gamma))."""
    return NormalizedAdam(params, lr, boundaries, gamma, eps)
