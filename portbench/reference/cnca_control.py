"""The control of the ``enc_train`` cells: the encoder-conditioned reference
(``reference.cnca_trainer.ReferenceEncTrainer``) put in the program's
place with TF32 on for its products and convolutions, one step below the
float32 the configuration states. It has to come out as not correct; the
readings it gives set the upper end of each limit."""

from __future__ import annotations


def enc_train_control():
    """A ``make_system`` for the ``enc_train`` harness that builds the control."""
    from portbench.reference.cnca_trainer import ReferenceEncTrainer

    return lambda **kw: ReferenceEncTrainer(tf32=True, **kw)
