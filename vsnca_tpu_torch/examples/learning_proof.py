"""One-command visual learning proof — the port's copy of
``examples/learning_proof.py``: train the ExtraChannels variant with the
MSE auxiliary loss to reproduce video content through its grayscale
conditioning channel, then stylize an unseen drifting test video with the
persistent-state stylizer and write the demo artifacts (the loss plot
where matplotlib is installed).

    python -m vsnca_tpu_torch.examples.learning_proof --out out/learning_proof
    python -m vsnca_tpu_torch.examples.learning_proof --size 32 --iters 150 --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--fc-dim", type=int, default=96)
    ap.add_argument("--out", default="out/learning_proof")
    ap.add_argument("--test-frames", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from vsnca_tpu_torch.config import LossConfig, NCAConfig, TrainConfig
    from vsnca_tpu_torch.data.preprocess import synthetic_video
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.infer.stylize import VideoStylizer
    from vsnca_tpu_torch.train.trainer import DyNCATrainer
    from vsnca_tpu_torch.utils.display import plot_losses, plotting_available, to_uint8

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    s = args.size
    nca = NCAConfig(c_in=13, seed_channels=12, fc_dim=args.fc_dim, padding_mode="circular")
    loss = LossConfig(overflow_weight=100.0, auxiliary_weight=10.0, auxiliary_loss_type="MSE")
    train = TrainConfig(
        img_size=(s, s), batch_size=4, pool_size=64,
        step_range=(16, 49), step_buckets=(16, 32, 48), inject_seed_every=8,
        lr=2e-3, lr_decay_steps=(max(args.iters // 2, 1),), max_iterations=args.iters,
    )
    trainer = DyNCATrainer(nca, loss, train, device=device)
    video = torch.from_numpy(synthetic_video((s, s), 8)).permute(0, 3, 1, 2).contiguous() \
        .to(device)
    rng = np.random.RandomState(0)

    losses = []
    t0 = time.time()
    for i in range(args.iters):
        idx = rng.choice(8, train.batch_size)
        aux = video[torch.as_tensor(idx, device=device)]
        inputs = {"aux_imgs": aux, "aux_gs": aux.mean(dim=1, keepdim=True)}
        sync = i % 25 == 0 or i == args.iters - 1
        log = trainer.train_iteration(inputs, sync=sync)
        if sync:
            losses.append(log.loss)
            print(f"iter {i:5d} loss={log.loss:.4f} "
                  f"({(i + 1) / (time.time() - t0):.1f} it/s)", flush=True)
    if plotting_available():
        plot_losses(losses, os.path.join(args.out, "training_loss.png"))
    else:
        print("matplotlib is not installed: no training_loss.png")

    # --- inference on UNSEEN content (persistent-state stylizer) ---
    styl = VideoStylizer(trainer.params, nca, s, step_n=24, device=device)
    test = synthetic_video((s, s), args.test_frames, seed=3)
    rows, gif_frames, errs = [], [], []
    for f in test:
        out = styl.step_frame(f[None]).cpu().numpy()[0]
        content = (f + 1.0) / 2.0
        err = np.abs(out - content)
        errs.append(float((err ** 2).mean()))
        rows.append(np.concatenate([content, out, np.clip(err * 4.0, 0, 1)], axis=1))
        gif_frames.append(np.concatenate([content, out], axis=1))
    grid = to_uint8(np.concatenate(rows, axis=0))
    Image.fromarray(grid).save(os.path.join(args.out, "content_output_error.png"))
    frames = [Image.fromarray(to_uint8(g)) for g in gif_frames]
    frames[0].save(os.path.join(args.out, "content_vs_output.gif"), save_all=True,
                   append_images=frames[1:], duration=250, loop=0)

    baseline = float((((test[-1] + 1) / 2 - 0.5) ** 2).mean())
    print(f"final train loss {losses[-1]:.4g}; unseen-content MSE "
          f"{errs[-1]:.4g} (gray baseline {baseline:.4g})")
    print(f"artifacts in {args.out}/")
    if errs[-1] >= baseline * 0.25:
        print("WARNING: generalization below the committed demo quality")
    return {"losses": losses, "errors": errs, "baseline": baseline}


if __name__ == "__main__":
    main()
