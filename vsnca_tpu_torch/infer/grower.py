"""Interactive grower — the port's counterpart of
``vsnca_tpu/infer/grower.py``: step-by-step growth of the encoder-
conditioned NCA toward a goal image, with goal switching and
click-to-damage, for a notebook or UI loop.

The state is NCHW [1, C, S, S] on ``device``. On a card every ``step(n)``,
n >= 1, runs the rollout kernels of ``ops/fused_cnca.py`` (two launches a
step); on the CPU their plain version. Each call draws its mask seed from
the grower's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vsnca_tpu_torch.config import ConditionedNCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.models.conditioned_nca import conditioned_nca_seed, encode_goal
from vsnca_tpu_torch.ops.fused_cnca import fused_cnca_rollout


class InteractiveGrower:
    def __init__(self, params: dict, cfg: ConditionedNCAConfig, goal_image,
                 size: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 device=None):
        """``goal_image`` [1, H, W, 3] in [0, 1] (array or tensor, the JAX
        grower's layout); ``params`` the flat ConditionedNCA dict."""
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(v).to(self.device, torch.float32)
                       for k, v in params.items()}
        self.cfg = cfg
        self.size = size or cfg.image_size
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.reset()
        self.set_goal(goal_image)

    @torch.no_grad()
    def set_goal(self, goal_image) -> None:
        """Switch the goal mid-growth: [1, H, W, 3] in [0, 1]."""
        g = torch.as_tensor(goal_image, dtype=torch.float32).to(self.device)
        self.goal_encoding = encode_goal(self.params, self.cfg,
                                         g.permute(0, 3, 1, 2).contiguous()).contiguous()

    def reset(self) -> None:
        self.state = conditioned_nca_seed(self.cfg, 1, self.size, self.device)

    @torch.no_grad()
    def step(self, n: int = 1) -> np.ndarray:
        """Grow ``n`` steps; returns the RGB readout (``rgb``)."""
        if n >= 1:
            seed = int(torch.randint(0, 1 << 30, (), generator=self.generator))
            self.state = fused_cnca_rollout(self.params, self.state, self.goal_encoding, seed,
                                            self.cfg, n)
        return self.rgb()

    def rgb(self) -> np.ndarray:
        """The target channels clipped to [0, 1], [S, S, 3] on the host."""
        rgb = self.state[0, : self.cfg.num_target_channels].clamp(0.0, 1.0)
        return rgb.permute(1, 2, 0).cpu().numpy()

    def damage(self, x: int, y: int, radius: int = 3) -> None:
        """Zero a circular patch around (x, y) — the click-to-damage brush."""
        yy, xx = np.ogrid[: self.size, : self.size]
        keep = ((xx - x) ** 2 + (yy - y) ** 2 > radius**2).astype(np.float32)
        self.state = self.state * torch.from_numpy(keep).to(self.device)
