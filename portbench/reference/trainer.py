"""The DyNCA training iteration in plain PyTorch: the benchmark's reference
for the training cells, written from the published training loop
(IVRL/DyNCA's fit scripts, the ConditioneDyNCA experiments) as this system
defines it:

- a sample pool of states (zeros at the start), a batch drawn without
  replacement, its first row replaced by the seed state every
  ``inject_seed_every`` iterations;
- the rollout of ``step_n`` steps (``reference.nca``), with RGB frames
  tapped after the chunks of a tap plan (the video-motion schedule);
- with a vector-field term, one step from the same states without a
  gradient (masks from the iteration's seed xor ``PREROLL_SEED_XOR``) gives
  the flow's "before" frame;
- the loss (``reference.losses.total_loss``), its draws from a CPU
  generator seeded with the iteration's seed + 1;
- each parameter's gradient divided by its norm (+ 1e-8), then Adam
  (beta 0.9 / 0.999, eps 1e-8, the configuration's learning rate);
- the final state's seed channels written back to the pool.

The host-side draws follow the trainer's protocol: batch rows from
``np.random.RandomState(seed)``, the iteration's seed from
``torch.Generator(seed)`` after the draws of the published initialisation.
The step count is the caller's.

With ``tf32`` the products and convolutions run in TF32: the control.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import losses, nca

PREROLL_SEED_XOR = 0x5BD1E995
CHECKPOINT_STEPS = 8


class ReferenceTrainer:
    def __init__(self, model: dict, loss: dict, train: dict, params: dict, vgg, msoe,
                 seed: int, style: torch.Tensor, target_video: Optional[torch.Tensor],
                 device, tf32: bool = False):
        self.model, self.loss_cfg, self.train = model, loss, train
        self.vgg, self.msoe, self.device, self.tf32 = vgg, msoe, torch.device(device), tf32
        self.params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.rng = np.random.RandomState(seed)
        self.gen = torch.Generator().manual_seed(seed)
        c = model["c_in"]
        cc = {"edges": 3, "pos_emb": 2}.get(model.get("conditioning"), 0)
        p, f = 4 * c + cc, model["fc_dim"]
        # the published initialisation's draws come first from this generator
        torch.randn((p, f), generator=self.gen)
        torch.rand(f, generator=self.gen)
        torch.randn((f, c), generator=self.gen)
        h, w = train["img_size"]
        self.pool = torch.zeros((train["pool_size"], c, h, w), device=self.device)
        self.iteration_index = 0
        self.last_idx = None
        self._flags()
        self.style = style
        self.style_feats = losses.style_features(vgg, style, (h, w)) \
            if loss.get("appearance_weight") else None
        self.motion_feats = losses.target_motion_features(msoe, target_video,
                                                          loss["motion_img_size"]) \
            if loss.get("video_motion_weight") else None
        self.field = losses.circular_field(*loss["motion_img_size"]) \
            if loss.get("vector_field_motion_weight") else None

    def _flags(self):
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def _rollout(self, x, cond, seed, chunks, tail):
        params, model = self.params, self.model

        def run(x, a, b):
            for s in range(a, b):
                x = nca.step(params, x, cond, model, seed, s)
            return x

        bounds, acc = [], 0
        for c in chunks:
            acc += c
            bounds.append(acc)
        total = acc + tail
        taps, pos = [], 0
        for stop in bounds + [total]:
            while pos < stop:
                end = min(stop, pos + CHECKPOINT_STEPS)
                x = checkpoint(run, x, pos, end, use_reentrant=False)
                pos = end
            if stop in bounds and len(taps) < len(bounds):
                taps.append(x)
        return x, taps

    def iteration(self, feed: dict, step_n: int, chunks=(), tail: int = 0,
                  mark: Optional[Callable[[str], None]] = None) -> float:
        mark = mark or (lambda name: None)
        self._flags()
        tr, lc, model = self.train, self.loss_cfg, self.model
        i = self.iteration_index
        idx = self.rng.choice(tr["pool_size"], tr["batch_size"], replace=False)
        self.last_idx = idx
        states = self.pool[torch.as_tensor(idx, device=self.device)]
        if tr["inject_seed_every"] and i % tr["inject_seed_every"] == 0:
            states = states.clone()
            states[:1] = 0.0
        seed = int(torch.randint(0, 1 << 30, (), generator=self.gen))
        b, _, h, w = states.shape
        aux = feed.get("aux")
        gray = aux.mean(dim=1, keepdim=True) if aux is not None else None
        cond = nca.conditioning(model, b, h, w, gray, self.device)
        for p in self.params.values():
            p.grad = None
        mark("rollout forward")
        terms = {"step_n": step_n, "aux": aux, "style_feats": self.style_feats}
        if lc.get("vector_field_motion_weight"):
            with torch.no_grad():
                pre = nca.step(self.params, states, cond, model, seed ^ PREROLL_SEED_XOR, 0)
            terms["before"] = 2.0 * pre[:, :3]
        if not chunks:
            chunks, tail = (step_n,), 0
        state, taps = self._rollout(states, cond, seed, tuple(chunks), tail)
        frames = [2.0 * t[:, :3] for t in taps]
        terms.update(state=state, frames=frames, after=frames[-1])
        if self.motion_feats is not None:
            start, nf = feed["window"]
            terms["motion_feats"] = self.motion_feats[start:start + nf - 1]
        mark("loss forward")
        loss = losses.total_loss(lc, self.vgg, self.msoe, terms,
                                 torch.Generator().manual_seed(seed + 1), self.field)
        mark("loss backward")
        state.register_hook(lambda g: mark("rollout backward"))
        loss.backward()
        mark("optimizer")
        self._adam()
        mark("end")
        new = state.detach()[:, :model["c_in"]]
        self.pool[torch.as_tensor(idx, device=self.device)] = new
        self.iteration_index += 1
        return float(loss.detach())

    @torch.no_grad()
    def _adam(self):
        self.t += 1
        lr = self.train["lr"]
        b1, b2, eps = 0.9, 0.999, 1e-8
        for k, p in self.params.items():
            g = p.grad / (torch.linalg.vector_norm(p.grad) + 1e-8)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))

    def written_rows(self) -> torch.Tensor:
        """The states the last iteration wrote back to the pool."""
        return self.pool[torch.as_tensor(self.last_idx, device=self.device)].clone()

