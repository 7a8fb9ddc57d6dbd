"""The sample pool — the port's copy of ``DevicePool`` and
``inject_seed_into_batch`` (``vsnca_tpu/pool/sample_pool.py:22,55``), on
NCHW states kept on the device. Batch indices are drawn on the host from a
``np.random.RandomState``, as the JAX package draws them, so both packages
draw the same indices from the same seed."""

from __future__ import annotations

import numpy as np
import torch


class DevicePool:
    """Device-resident state pool [P, C, H, W]."""

    def __init__(self, states: torch.Tensor):
        self.states = states

    @property
    def size(self) -> int:
        return self.states.shape[0]

    def sample_indices(self, rng: np.random.RandomState, batch: int) -> np.ndarray:
        """Without-replacement batch draw on the host RNG."""
        return rng.choice(self.size, batch, replace=False)

    def gather(self, idx: np.ndarray) -> torch.Tensor:
        return self.states[torch.as_tensor(idx, device=self.states.device)]

    def scatter(self, idx: np.ndarray, new_states: torch.Tensor) -> None:
        """Write rollout results back."""
        self.states[torch.as_tensor(idx, device=self.states.device)] = new_states


def inject_seed_into_batch(batch_states: torch.Tensor, seed_state: torch.Tensor,
                           n: int = 1) -> torch.Tensor:
    """A copy of the batch with its first n entries replaced by fresh seeds."""
    out = batch_states.clone()
    out[:n] = seed_state[:n]
    return out
