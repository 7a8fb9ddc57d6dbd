"""The controls: the reference put in the program's place, computed one
step below the precision the cell states. A control has to come out as not
correct; the readings it gives set the upper end of each limit.

- Serving (bf16 operands): ``ReferenceStylizer`` with float8 (e4m3)
  operands at the same places.
- Training (float32, TF32 off): ``reference.trainer.ReferenceTrainer`` with
  TF32 on for its products and convolutions.
"""

from __future__ import annotations

import torch

from portbench.reference import nca


class ReferenceStylizer:
    """The stylizer's contract (a persistent state, ``step_frame`` of host
    frames [S, H, W, 3] in [-1, 1] to RGB [S, H, W, 3] in [0, 1], the frame
    counter keying the masks), computed by the reference."""

    def __init__(self, params, model: dict, serve: dict, size: int, streams: int, device,
                 operand):
        self.params = params
        self.model = model
        self.step_n = serve["step_n"]
        self.operand = operand
        self.device = torch.device(device)
        self.state = torch.zeros((streams, model["c_in"], size, size), device=self.device)
        self.frame_idx = 0

    @torch.no_grad()
    def step_frame(self, frame):
        f = torch.as_tensor(frame, dtype=torch.float32).to(self.device)
        gray = f.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2).contiguous()
        self.frame_idx += 1
        torch.backends.cuda.matmul.allow_tf32 = False
        self.state = nca.rollout(self.params, self.state, nca.edge_map(gray), self.model,
                                 self.frame_idx, self.step_n, operand=self.operand)
        return nca.to_rgb01(self.state)


def serve_control(operand=torch.float8_e4m3fn):
    """A ``make_system`` for the serving harness that builds the control."""
    def make(params, model, serve, size, streams, device):
        return ReferenceStylizer(params, model, serve, size, streams, device, operand)
    return make


def train_control():
    """A ``make_system`` for the training harness that builds the control."""
    from portbench.reference.trainer import ReferenceTrainer

    def make(**kw):
        return ReferenceTrainer(tf32=True, **kw)
    return make
