"""Training CLI — the port's counterpart of ``vsnca_tpu/train/cli.py`` for
the presets it can train.

Usage (on the card; ``--device cpu`` runs the plain path):
    python -m vsnca_tpu_torch.train.cli --preset static_texture \
        [--style-image path | synthetic] [--max-iterations N] \
        [--img-size S] [--out out/run]

Writes ``<out>/args.json`` and, at the end, ``<out>/checkpoint/state.pkl``
in the JAX package's pickle layout (``vsnca_tpu/export/checkpoint.py``:
{params, opt_state, pool, iteration} as numpy arrays), which
``convert.load_params_pickle`` reads; pool states are NCHW. Orbax
checkpoints, preview artifacts, videos and ``--dp`` are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import time

import numpy as np
import torch


def setup_args(argv=None):
    from vsnca_tpu_torch.train.presets import PRESETS

    p = argparse.ArgumentParser(description="vsnca_tpu_torch trainer")
    p.add_argument("--preset", default="static_texture", choices=sorted(PRESETS))
    p.add_argument("--style-image", default="synthetic",
                   help="style image path, or 'synthetic'")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="out/run")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--no-precompute", action="store_true",
                   help="recompute the target's VGG features every iteration")
    return p.parse_args(argv)


def save_checkpoint(path: str, trainer, nca_cfg) -> None:
    """The trainer's state as numpy arrays in ``path/state.pkl`` plus
    ``metadata.json`` (the JAX package's pickle backend layout)."""
    os.makedirs(path, exist_ok=True)
    adam = trainer.optimizer.adam
    opt_state = {}
    for name, p in trainer.params.items():
        st = adam.state.get(p, {})
        opt_state[name] = {k: np.asarray(v.detach().cpu()) for k, v in st.items()}
    state = {
        "params": {k: np.asarray(v.detach().cpu()) for k, v in trainer.params.items()},
        "opt_state": opt_state,
        "pool": np.asarray(trainer.pool.states.cpu()),
        "iteration": trainer.iteration,
    }
    with open(os.path.join(path, "state.pkl"), "wb") as f:
        pickle.dump(state, f)
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"nca": dataclasses.asdict(nca_cfg)}, f, indent=2, default=str)


def main(argv=None):
    args = setup_args(argv)

    from vsnca_tpu_torch.data.preprocess import (
        preprocess_style_image,
        synthetic_style_image,
    )
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.train.presets import PRESETS
    from vsnca_tpu_torch.train.trainer import DyNCATrainer

    device = resolve_device(args.device)
    preset_kwargs = {"img_size": args.img_size} if args.img_size else {}
    nca_cfg, loss_cfg, train_cfg = PRESETS[args.preset](**preset_kwargs)
    overrides = {"seed": args.seed}
    for field, value in (("max_iterations", args.max_iterations),
                         ("batch_size", args.batch_size), ("lr", args.lr)):
        if value is not None:
            overrides[field] = value
    train_cfg = dataclasses.replace(train_cfg, **overrides)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "args.json"), "w") as f:
        json.dump({"cli": vars(args), "nca": dataclasses.asdict(nca_cfg),
                   "loss": dataclasses.asdict(loss_cfg),
                   "train": dataclasses.asdict(train_cfg)}, f, indent=2)

    hw = train_cfg.img_size
    if args.style_image == "synthetic":
        style = synthetic_style_image(hw, train_cfg.batch_size)
    else:
        style = preprocess_style_image(args.style_image, hw, train_cfg.batch_size)
    style = torch.from_numpy(style * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous().to(device)

    vgg, vgg_pretrained = load_vgg16(device=device)
    print(f"VGG16 weights: {'pretrained' if vgg_pretrained else 'RANDOM FALLBACK'}")
    trainer = DyNCATrainer(nca_cfg, loss_cfg, train_cfg, vgg_params=vgg, device=device)
    print(f"DyNCA param count: {sum(v.numel() for v in trainer.params.values())}; "
          f"device {device}")

    inputs = {"target_style": style}
    if loss_cfg.appearance_weight and not args.no_precompute:
        # constant across iterations: extract once
        inputs["target_style_features"] = precompute_target_style_features(
            vgg, style, loss_cfg.appearance_loss_type, hw
        )

    t0 = time.time()
    for i in range(train_cfg.max_iterations):
        sync = (i % args.log_every == 0) or (i == train_cfg.max_iterations - 1)
        log = trainer.train_iteration(inputs, sync=sync)
        if sync and i % args.log_every == 0:
            rate = (i + 1) / (time.time() - t0)
            terms = " ".join(f"{k}={v:.4f}" for k, v in log.logs.items())
            print(f"iter {i:5d} loss={log.loss:.4f} {terms} ({rate:.2f} it/s)",
                  flush=True)

    save_checkpoint(os.path.join(args.out, "checkpoint"), trainer, nca_cfg)
    print(f"done: {trainer.iteration} iterations, final loss "
          f"{trainer.history[-1].loss:.4f}")


if __name__ == "__main__":
    main()
