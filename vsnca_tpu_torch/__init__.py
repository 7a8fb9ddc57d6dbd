"""vsnca_tpu_torch — the PyTorch/CUDA port of ``vsnca_tpu`` for NVIDIA Hopper.

The JAX package ``vsnca_tpu`` stays the reference; this package mirrors its
layout and names so each module has an obvious counterpart:

- ``config``   — own copy of the typed frozen configs.
- ``ops``      — perception stencils, padding, resize, CPE, convolution
  helpers, and the CUDA kernels with their wrappers: the DyNCA rollout step
  (``ops/fused_step.py`` + ``csrc/nca_step.cu``), the DyNCA training pair
  (``ops/fused_train.py`` + ``csrc/nca_train.cu``) and the ConditionedNCA
  rollout and training pair (``ops/fused_cnca.py`` + ``csrc/nca_cnca.cu``),
  built by ``ops/_build.py``.
- ``models``   — the DyNCA cell, VGG16, and the encoder-conditioned NCA with
  its ImageEncoder, as plain functions on tensors.
- ``infer``    — persistent-state video stylizer and its HTTP server; the
  interactive grower of the encoder-conditioned NCA.
- ``train``    — the DyNCA trainer (the five presets) and the encoder
  trainer, each with its CLI; the video-motion and vector-field protocols.
- ``export``   — checkpoints in the JAX package's pickle layout (both
  packages read each other's), the WebGL JSON export and its validator.
- ``utils``    — the video writer and the stylization drivers, flow images,
  plots, the metrics logger, experiment-directory helpers; ``apps`` the
  static results browser.
- ``convert``  — parameters from the JAX package and back (numpy arrays,
  pickles).

Conventions that differ from the JAX package: states, frames-in-flight and
conditioning maps are NCHW (``[B, C, H, W]``), the layout of the TPU fused
path's persistent state; parameters keep the JAX layout (input-major
``w1: [P, F]``, ``w2: [F, C]``). Entry points take an explicit ``device``
and run on ``cuda`` unless ``device="cpu"`` is passed; without a card they
raise instead of falling back. Randomness comes from explicit
``torch.Generator`` objects.

The package imports ``torch``, never ``jax`` and nothing of ``vsnca_tpu``.
"""

__version__ = "0.1.0"
