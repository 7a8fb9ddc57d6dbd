"""Export validator — the port's copy of ``vsnca_tpu/export/webgl_sim.py``:
execute an exported WebGL JSON model and compare it against the float
model.

The browser runtime (docs/dynca.js) dequantizes the weight atlas and runs
perception → dense x2 → stochastic update; this simulator replays that
pipeline with the SAME dequantized weights through the port's
``dynca_rollout``, bounding the quantization error a deployed model will
show. (The uint8 path mirrors the texture precision actually uploaded to
the GPU.) On the card both rollouts run the rollout kernel (``nca_step``
for perception scales (0,), ``nca_step_ms`` for (0, 1)); on the CPU its
eager steps.
"""

from __future__ import annotations

import numpy as np
import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.export.webgl import load_webgl_model


def params_from_webgl(path: str, cfg: NCAConfig, quantize_uint8: bool = False,
                      device=None) -> dict:
    """Rebuild a params dict (float32 tensors on ``device``) from an
    exported JSON (model 0).

    ``quantize_uint8`` reproduces the texture precision of the browser
    upload (see ``load_webgl_model``).
    """
    dev = resolve_device(device)
    mats = load_webgl_model(path, quantize_uint8)
    l1, l2 = (np.asarray(m, np.float32) for m in mats)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in (("w1", l1[:-1]), ("b1", l1[-1]), ("w2", l2[:-1]), ("b2", l2[-1]))}


def validate_export(
    path: str,
    params: dict,
    cfg: NCAConfig,
    size: int = 64,
    n_steps: int = 24,
    seed: int = 0,
    quantize_uint8: bool = True,
    device=None,
) -> dict:
    """Roll both the float model and the dequantized export from one seed
    state with the same update masks (``seed`` keys both, and draws a
    random seed state); returns a dict of divergence metrics."""
    from vsnca_tpu_torch.models.dynca import dynca_rollout, dynca_seed, make_conditioning

    dev = resolve_device(device)
    params = {k: torch.as_tensor(v).detach().to(dev, torch.float32) for k, v in params.items()}
    re_params = params_from_webgl(path, cfg, quantize_uint8=quantize_uint8, device=dev)

    state = dynca_seed(cfg, 1, size, generator=torch.Generator().manual_seed(seed), device=dev)
    if cfg.n_seed_channels < cfg.c_in:
        state = torch.cat([state, torch.zeros((1, cfg.c_in - cfg.n_seed_channels, size, size),
                                              device=dev)], dim=1)
    cond_img = (torch.zeros((1, 1, size, size), device=dev)
                if cfg.conditioning == "edges" else None)
    cond = make_conditioning(cfg, (size, size), cond_img=cond_img, batch=1, device=dev)

    with torch.no_grad():
        s_ref, rgb_ref = dynca_rollout(params, state, seed, cfg, n_steps, cond)
        s_exp, rgb_exp = dynca_rollout(re_params, state, seed, cfg, n_steps, cond)

    return {
        "state_max_abs_diff": float((s_ref - s_exp).abs().max()),
        "rgb_mean_abs_diff": float((rgb_ref - rgb_exp).abs().mean()),
        "weight_max_abs_diff": max(float((params[k] - re_params[k]).abs().max())
                                   for k in ("w1", "b1", "w2", "b2")),
    }
