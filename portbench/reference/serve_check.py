"""The comparison that decides ``correct`` in a serving cell.

Three numbers, each against its limit in ``limits/<cell>.json``:

- ``rgb_gap``: over the sampled ticks of the window, the largest absolute
  difference between the RGB the program delivered to the host and the
  reference's RGB for the same tick, stepped by the reference from the state
  the program started that tick from (the persistent state), with the same
  content frame, frame counter and weights.
- ``state_gap``: the same ticks, every channel of the state the program left,
  as the largest absolute difference over the largest absolute value of the
  reference's state.
- ``start_gap``: the reference alone, from the seed state, through the first
  ``start_frames`` ticks, against the program's state after them (relative,
  as ``state_gap``): the start that the stepped check skips.

The reference computes at the configuration's operand type (``operand``);
the control computes it one step lower, in the program's place.
"""

from __future__ import annotations

import torch

from portbench.reference import nca


def operand_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": None}[name]


def _gray_cond(frame_np, device):
    f = torch.as_tensor(frame_np, dtype=torch.float32).to(device)
    gray = f.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2).contiguous()
    return nca.edge_map(gray)


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-6)


@torch.no_grad()
def check(cell, params, start, samples, frame_of, device, operand) -> dict:
    model = cell.config["nca"]
    step_n = cell.config["serve"]["step_n"]
    limits = cell.limits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rgb_gap, state_gap = 0.0, 0.0
    for k, prev, out, rgb in samples:
        cond = _gray_cond(frame_of(k), device)
        ref = nca.rollout(params, prev.float(), cond, model, k, step_n, operand=operand)
        got = torch.as_tensor(rgb).to(device)
        rgb_gap = max(rgb_gap, float((got - nca.to_rgb01(ref)).abs().max()))
        state_gap = max(state_gap, _rel(out, ref))
    k_start, state_start, _ = start
    x = torch.zeros_like(state_start, dtype=torch.float32)
    for k in range(1, k_start + 1):
        x = nca.rollout(params, x, _gray_cond(frame_of(k), device), model, k, step_n,
                        operand=operand)
    start_gap = _rel(state_start, x)
    if not samples:
        rgb_gap = state_gap = float("nan")
    return {
        "rgb_gap": {"value": rgb_gap, "limit": limits["rgb_gap"]},
        "state_gap": {"value": state_gap, "limit": limits["state_gap"]},
        "start_gap": {"value": start_gap, "limit": limits["start_gap"]},
    }
