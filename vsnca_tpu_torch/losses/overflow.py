"""Overflow regularizer: mean |state − clamp(state, −1, 1)| (the port's copy
of ``vsnca_tpu/losses/overflow.py``)."""

import torch


def overflow_loss(nca_state: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(nca_state - torch.clamp(nca_state, -1.0, 1.0)))
