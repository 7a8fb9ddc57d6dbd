"""EncoderConditioning training CLI — the port's counterpart of
``vsnca_tpu/train/encoder_cli.py``, with the same flags and ``--device``.

Usage (on the card; ``--device cpu`` runs the plain path):
    python -m vsnca_tpu_torch.train.encoder_cli [--image-dir DIR] \
        [--style-image path | synthetic] [--epochs N] [--out out/encoder_run]

Without ``--image-dir`` the goal images are the 8 frames of the synthetic
drifting texture, as in the JAX CLI. Writes ``<out>/args.json`` and, every
``--save-every`` epochs and at the end (also after Ctrl-C or a NaN loss),
``<out>/checkpoint/state.pkl`` ({params, opt_state, iteration} as numpy
arrays, through ``export/checkpoint.py``; the params, and Adam's moments,
in the JAX package's tree layout, so that both packages read it:
``convert.load_params_pickle`` gives the port's flat dict) with
``metadata.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch


def setup_args(argv=None):
    p = argparse.ArgumentParser(description="vsnca_tpu_torch encoder-conditioned trainer")
    p.add_argument("--image-dir", default=None,
                   help="conditioning image folder; default synthetic")
    p.add_argument("--style-image", default="synthetic")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--num-hidden-channels", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100_000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pool-size", type=int, default=1024)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--num-damaged", type=int, default=0)
    p.add_argument("--damage-radius", type=int, default=3)
    p.add_argument("--appearance-loss-type", default="OT")
    p.add_argument("--appearance-loss-weight", type=float, default=1.0)
    p.add_argument("--content-loss-weight", type=float, default=0.1)
    p.add_argument("--overflow-loss-weight", type=float, default=1.0)
    p.add_argument("--min-steps", type=int, default=48)
    p.add_argument("--max-steps", type=int, default=96)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out/encoder_run")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


def checkpoint_state(trainer) -> dict:
    """The trainer's state in the JAX encoder CLI's layout: params and
    Adam's moments as the JAX tree (``convert.cnca_params_to_jax``), the
    iteration."""
    from vsnca_tpu_torch.convert import cnca_params_to_jax

    adam = trainer.optimizer.state_arrays()
    return {"params": cnca_params_to_jax(trainer.params),
            "opt_state": {"count": adam["count"], "mu": cnca_params_to_jax(adam["mu"]),
                          "nu": cnca_params_to_jax(adam["nu"])},
            "iteration": trainer.iteration}


def main(argv=None):
    args = setup_args(argv)

    from vsnca_tpu_torch.config import ConditionedNCAConfig
    from vsnca_tpu_torch.data.dataset import ConditioningDataset
    from vsnca_tpu_torch.data.preprocess import (
        preprocess_style_image,
        synthetic_style_image,
        synthetic_video,
    )
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.export.checkpoint import save_checkpoint
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.train.encoder_trainer import ConditionedNCATrainer

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    s = args.image_size
    if args.image_dir:
        dataset = ConditioningDataset.from_folder(args.image_dir, s, device)
    else:
        dataset = ConditioningDataset((synthetic_video((s, s), 8) + 1.0) / 2.0, device)
    if args.style_image == "synthetic":
        style = synthetic_style_image((s, s), 1)
    else:
        style = preprocess_style_image(args.style_image, (s, s), 1)
    style = torch.from_numpy(style).permute(0, 3, 1, 2).contiguous().to(device)

    vgg, pretrained = load_vgg16(device=device)
    print(f"VGG16 weights: {'pretrained' if pretrained else 'RANDOM FALLBACK'}")
    cfg = ConditionedNCAConfig(image_size=s, num_hidden_channels=args.num_hidden_channels)
    trainer = ConditionedNCATrainer(
        cfg, dataset, style, vgg,
        nca_steps=(args.min_steps, args.max_steps),
        lr=args.lr, pool_size=args.pool_size,
        num_damaged=args.num_damaged, damage_radius=args.damage_radius,
        appearance_loss_type=args.appearance_loss_type,
        appearance_weight=args.appearance_loss_weight,
        content_weight=args.content_loss_weight,
        overflow_weight=args.overflow_loss_weight,
        seed=args.seed, device=device,
    )
    print(f"ConditionedNCA param count: {sum(v.numel() for v in trainer.params.values())}; "
          f"device {device}")

    def save():
        save_checkpoint(os.path.join(args.out, "checkpoint"), checkpoint_state(trainer),
                        metadata={"cfg": dataclasses.asdict(cfg)})

    t0 = time.time()
    try:
        for i in range(args.epochs):
            loss, metrics = trainer.train_iteration(batch_size=args.batch_size)
            if i % args.log_every == 0:
                rate = (i + 1) / (time.time() - t0)
                terms = " ".join(f"{k}={v:.4f}" for k, v in metrics.items()
                                 if k != "log10loss")
                print(f"epoch {i:6d} loss={loss:.4f} {terms} ({rate:.2f} it/s)", flush=True)
            if args.save_every and i and i % args.save_every == 0:
                save()
    except (KeyboardInterrupt, FloatingPointError) as e:
        print(f"{type(e).__name__}: {e}; saving latest checkpoint...")
    save()
    print(f"done at epoch {trainer.iteration}")


if __name__ == "__main__":
    main()
