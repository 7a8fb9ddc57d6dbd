"""The sample pools — the port's copy of ``DevicePool``,
``inject_seed_into_batch`` and ``ListPool``
(``vsnca_tpu/pool/sample_pool.py:22,55,61``). ``DevicePool`` keeps NCHW
states on the device; batch indices are drawn on the host from a
``np.random.RandomState``, as the JAX package draws them, so both packages
draw the same indices from the same seed. ``ListPool`` is the
EncoderConditioning pool: host arrays or None, one an entry."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

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


class ListPool:
    """List-backed pool of None-or-host-array entries (EncoderConditioning).
    ``get`` replaces None and dead entries with fresh seeds from
    ``reseed_fn``; ``set`` writes grown states back."""

    def __init__(self, size: int):
        self.entries: List[Optional[np.ndarray]] = [None] * size

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, idxs: Sequence[int], reseed_fn: Callable[[int], np.ndarray],
            is_dead_fn: Optional[Callable[[np.ndarray], bool]] = None) -> np.ndarray:
        out = []
        for i in idxs:
            e = self.entries[i]
            if e is None or (is_dead_fn is not None and is_dead_fn(e)):
                e = reseed_fn(1)[0]
            out.append(e)
        return np.stack(out)

    def set(self, idxs: Sequence[int], states) -> None:
        for k, i in enumerate(idxs):
            self.entries[i] = np.asarray(states[k])
