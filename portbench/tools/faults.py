"""Faults planted in the program, for the check that a broken timed path
comes out not correct: the benchmark's tests plant them at a tiny size on
the CPU, ``tools/readings.py --system fault-<kind>`` on the card at a cell's
own size. Each ``make_*`` gives a ``make_system`` for the harness.

Serving: 'unchanged' (a tick returns its state unchanged), 'half' (the
second half of the streams is left out), 'altered' (a value of the
delivered RGB is changed where it is made). Training: 'unchanged' (the
optimizer's step leaves the parameters as they are), 'half' (the loss sees
the first half of the batch; its means run over that half; needs
``half_batch_loss`` in place while the trainer is built), 'altered' (the
loss the iteration returns is 1 % off).
"""

import torch

def _rgb(state):
    return (state[:, :3].permute(0, 2, 3, 1) * 2.0).clamp(-1.0, 1.0) * 0.5 + 0.5


class FaultyStylizer:
    """The port's stylizer with a fault: 'unchanged' (a tick returns its
    state unchanged), 'half' (the second half of the streams is left out),
    'altered' (a value of the delivered RGB is changed where it is made)."""

    def __init__(self, inner, kind):
        self.inner, self.kind = inner, kind

    @property
    def state(self):
        return self.inner.state

    @state.setter
    def state(self, value):
        self.inner.state = value

    def step_frame(self, frame):
        prev = self.inner.state
        rgb = self.inner.step_frame(frame)
        if self.kind == "unchanged":
            self.inner.state = prev
            return _rgb(prev)
        if self.kind == "half":
            n = prev.shape[0] // 2
            state = self.inner.state.clone()
            state[n:] = prev[n:]
            self.inner.state = state
            rgb = rgb.clone()
            rgb[n:] = _rgb(prev[n:])
            return rgb
        rgb = rgb.clone()
        rgb[:, 0, 0, 0] += 0.25
        return rgb


def make_serving_fault(kind):
    from portbench.harness.serve import program_stylizer

    def make(*args):
        return FaultyStylizer(program_stylizer(*args), kind)
    return make


def half_batch_loss(make_loss_fn):
    """A loss that sees the first half of the batch only (its terms' means
    then run over that half)."""
    def make(state):
        inner = make_loss_fn(state)

        def loss_fn(d, generator=None):
            b = d["nca_state"].shape[0]
            n = max(1, b // 2)

            def cut(v):
                if torch.is_tensor(v) and v.dim() and v.shape[0] == b:
                    return v[:n]
                if isinstance(v, list):
                    return [cut(t) for t in v]
                return v
            return inner({k: cut(v) for k, v in d.items()}, generator)
        return loss_fn
    return make


def make_training_fault(kind):
    from portbench.harness.train import ProgramTrainer

    class Faulty(ProgramTrainer):
        def __init__(self, **kw):
            super().__init__(**kw)
            if kind == "unchanged":
                self.trainer.optimizer.step = lambda: None

        def iteration(self, *args, **kw):
            value = super().iteration(*args, **kw)
            return value * 1.01 if kind == "altered" else value
    return lambda **kw: Faulty(**kw)
