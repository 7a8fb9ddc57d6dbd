"""Encoder-conditioned multi-style training (BASELINE config 5) with
preview grids — the port's copy of ``examples/train_encoder.py``
(train.ipynb / visualisation.ipynb equivalent).

Example:
    python -m vsnca_tpu_torch.examples.train_encoder --image-dir goals/ \
        --style style.jpg [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image-dir", default=None)
    p.add_argument("--style", default="synthetic")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--out", default="out/encoder")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vsnca_tpu_torch.config import ConditionedNCAConfig
    from vsnca_tpu_torch.convert import cnca_params_to_jax
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
    from vsnca_tpu_torch.utils.display import save_image_grid

    device = resolve_device(args.device)
    s = args.image_size
    if args.image_dir:
        dataset = ConditioningDataset.from_folder(args.image_dir, s, device)
    else:
        dataset = ConditioningDataset((synthetic_video((s, s), 8) + 1.0) / 2.0, device)
    style = (synthetic_style_image((s, s), 1) if args.style == "synthetic"
             else preprocess_style_image(args.style, (s, s), 1))
    style = torch.from_numpy(style).permute(0, 3, 1, 2).contiguous().to(device)

    vgg, _ = load_vgg16(device=device)
    cfg = ConditionedNCAConfig(image_size=s)
    trainer = ConditionedNCATrainer(cfg, dataset, style, vgg, content_weight=0.1,
                                    device=device)

    losses = []
    for i in range(args.epochs):
        loss, metrics = trainer.train_iteration(batch_size=8)
        losses.append(float(loss))
        if i % 50 == 0:
            print(f"epoch {i} loss={float(loss):.4f}")
            goals = dataset.sample(np.random.RandomState(i), 4)
            preview = trainer.grow_preview(goals)
            save_image_grid(preview.permute(0, 2, 3, 1).cpu().numpy(),
                            os.path.join(args.out, f"preview_{i}.png"))

    # the JAX encoder's tree, which both packages read
    save_checkpoint(os.path.join(args.out, "checkpoint"),
                    {"params": cnca_params_to_jax(trainer.params),
                     "iteration": trainer.iteration})
    return trainer, losses


if __name__ == "__main__":
    main()
