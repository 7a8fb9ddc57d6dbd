"""The encoder-conditioned NCA's training iteration in plain PyTorch: the
benchmark's reference for the ``enc_train`` cells, written from the
reference repository's ``EncoderConditioning/conditioned_trainer.py``
(:101-171) as this system defines it:

- a pool of seed states; a batch of ``batch_size`` rows drawn without
  replacement, its dead rows (no alive value above the threshold) reseeded
  and its first ``fresh_seeds`` rows fresh seeds;
- goal images drawn with replacement from the goal set;
- the batch trained ``steps_per_batch`` times, each from the state the
  previous one grew: encode the goals (``reference.cnca.encode``), grow
  ``step_n`` steps, the loss (``reference.cnca.total_loss``), each
  parameter's gradient divided by its norm + ``grad_norm_eps``, then Adam
  (beta 0.9 / 0.999, eps 1e-8) at ``lr`` times ``lr_decay_gamma`` for each
  of ``lr_decay_steps`` reached (MultiStepLR);
- the last grown state written back to the pool.

Departures from the reference repository: every train step of an iteration
grows the caller's step count (the repository draws 48-96 each, the system
rounds a draw to ``step_buckets``); the fire masks are the system's hash
(``reference.cnca``). The host-side draws follow the system's trainer: pool
rows from ``random.Random(seed).sample``, goal rows from
``np.random.RandomState(seed).randint``, each train step's mask seed and
then its OT subsample from ``torch.Generator(seed)``, after the draws of
torch's default convolution initialisation of the model's seven tensors.
No damage (the configuration's ``num_damaged`` is 0).

With ``tf32`` the products and convolutions run in TF32: the control.
"""

from __future__ import annotations

import random
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from portbench.reference import cnca


def init_draw_shapes(model: dict):
    """The shapes torch's default convolution initialisation draws, in
    order: the perception, the three 1x1 layers' weights (their biases are
    zeros), the encoder's first convolution's weight and bias, its second's
    weight."""
    c, _, e, d = cnca.widths(model)
    return ((c, 3, 3, 3), (d, 3 * c, 1, 1), (d, d, 1, 1), (c, d, 1, 1), (e, 6, 3, 3), (e,),
            (e, e, 3, 3))


class ReferenceEncTrainer:
    def __init__(self, model: dict, loss: dict, train: dict, params: dict, vgg, seed: int,
                 style: torch.Tensor, goals: torch.Tensor, device, tf32: bool = False):
        self.model, self.loss_cfg, self.train = model, loss, train
        self.vgg, self.goals, self.device, self.tf32 = vgg, goals, torch.device(device), tf32
        self.params = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.moved = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.py_rng = random.Random(seed)
        self.rng = np.random.RandomState(seed)
        self.gen = torch.Generator().manual_seed(seed)
        for shape in init_draw_shapes(model):
            torch.rand(shape, generator=self.gen)
        h, w = train["img_size"]
        self.pool = cnca.seed_states(model, train["pool_size"], h, w, self.device)
        self.fresh = cnca.seed_states(model, train["fresh_seeds"], h, w, self.device)
        self._flags()
        self.style_feats = cnca.style_features(vgg, style)
        self.last_idx = None

    def _flags(self):
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def _gather(self, idx) -> torch.Tensor:
        batch = self.pool[torch.as_tensor(idx, device=self.device)]
        _, a, _, _ = cnca.widths(self.model)
        dead = ~(batch[:, a].amax(dim=(1, 2)) > self.model["alpha_living_threshold"])
        batch = torch.where(dead[:, None, None, None], self.fresh[:1], batch)
        batch[:self.fresh.shape[0]] = self.fresh
        return batch

    def iteration(self, step_n: int, mark: Optional[Callable[[str], None]] = None,
                  follow: Sequence[dict] = ()) -> float:
        """One iteration; returns the last train step's loss. ``follow``, the
        parameters another trainer held after each of its train steps, are
        taken in place of this trainer's own after its update of the same
        step (the comparison steps from the program's parameters); ``moved``
        sums this trainer's own updates either way."""
        mark = mark or (lambda name: None)
        self._flags()
        tr = self.train
        idx = self.py_rng.sample(range(tr["pool_size"]), tr["batch_size"])
        self.last_idx = idx
        rows = self.rng.randint(0, self.goals.shape[0], size=tr["batch_size"])
        goals = self.goals[torch.as_tensor(rows, device=self.device)]
        state = self._gather(idx)
        for k in range(tr["steps_per_batch"]):
            for p in self.params.values():
                p.grad = None
            seed = int(torch.randint(0, 2 ** 30 - 1, (), generator=self.gen))
            mark("encode")
            enc = cnca.encode(self.params, goals, self.model)
            mark("rollout forward")
            grown = cnca.grow(self.params, state, enc, self.model, seed, step_n)
            mark("loss forward")
            loss = cnca.total_loss(self.loss_cfg, self.vgg, grown, goals, self.style_feats,
                                   self.gen)
            mark("loss backward")
            grown.register_hook(lambda g: mark("rollout backward"))
            loss.backward()
            mark("optimizer")
            before = {n: p.detach().clone() for n, p in self.params.items()}
            self._adam()
            with torch.no_grad():
                for n, p in self.params.items():
                    self.moved[n] += p - before[n]
                    if k < len(follow):
                        p.copy_(follow[k][n])
            mark("end")
            state = grown.detach()
        self.pool[torch.as_tensor(idx, device=self.device)] = state
        return float(loss.detach())

    @torch.no_grad()
    def _adam(self):
        tr = self.train
        lr = tr["lr"] * tr["lr_decay_gamma"] ** sum(self.t >= s for s in tr["lr_decay_steps"])
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for k, p in self.params.items():
            g = p.grad / (torch.linalg.vector_norm(p.grad) + tr["grad_norm_eps"])
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * mhat / (vhat.sqrt() + eps))

    def written_rows(self) -> torch.Tensor:
        """The states the last iteration wrote back to the pool."""
        return self.pool[torch.as_tensor(self.last_idx, device=self.device)].clone()
