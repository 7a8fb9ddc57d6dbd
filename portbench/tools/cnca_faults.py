"""Faults planted in the encoder-conditioned trainer, for the check that a
broken timed path comes out not correct: the benchmark's tests plant them
at a tiny size on the CPU, ``tools/cnca_readings.py --system fault-<kind>``
on the card at the cell's own size. Each is a ``make_system`` for the
``enc_train`` harness:

- 'no_goal': the goal encoding is zeroed (times 0, so the encoder still
  receives a gradient, of zero);
- 'one_step': the batch is trained once an iteration, not twice (the second
  train step returns the first's result);
- 'no_content': the loss leaves out the content term.
"""

from __future__ import annotations

FAULTS = ("no_goal", "one_step", "no_content")


def make_enc_training_fault(kind: str):
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}; one of {FAULTS}")
    from portbench.harness.enc_train import ProgramEncTrainer
    from vsnca_tpu_torch.train import encoder_trainer as et

    class Faulty(ProgramEncTrainer):
        def __init__(self, **kw):
            super().__init__(**kw)
            t, loss = self.trainer, kw["loss"]
            if kind == "no_content":
                t.loss_fn = et.make_encoder_loss_fn(
                    kw["vgg"], kw["style"], loss["appearance_loss_type"],
                    loss["appearance_weight"], 0.0, loss["overflow_weight"])
            if kind == "one_step":
                inner, last, calls = t._train_step, [], [0]

                def once(*args):
                    calls[0] += 1
                    if calls[0] % 2 == 0:
                        return last[0]
                    last[:] = [inner(*args)]
                    return last[0]
                t._train_step = once

        def iteration(self, step_n, mark=None):
            if kind != "no_goal":
                return super().iteration(step_n, mark)
            real = et.encode_goal
            et.encode_goal = lambda params, cfg, img: real(params, cfg, img) * 0.0
            try:
                return super().iteration(step_n, mark)
            finally:
                et.encode_goal = real
    return lambda **kw: Faulty(**kw)
