"""Training CLI — the port's counterpart of ``vsnca_tpu/train/cli.py``, for
the five presets.

Usage (on the card; ``--device cpu`` runs the plain path):
    python -m vsnca_tpu_torch.train.cli --preset static_texture \
        [--style-image path | synthetic] [--max-iterations N] \
        [--img-size S] [--out out/run]
    python -m vsnca_tpu_torch.train.cli --preset edge_conditioned \
        [--target-images dir] [--max-iterations N] [--out out/edges]
    python -m vsnca_tpu_torch.train.cli --preset vector_field_motion \
        [--motion-field circular] [--max-iterations N] [--out out/vf]
    python -m vsnca_tpu_torch.train.cli --preset video_motion \
        [--target-video clip.gif] [--max-iterations N] [--out out/vm]

``edge_conditioned`` and ``extra_channels`` train on content frames (a
folder of PNG/JPEG images, or 8 synthetic drifting frames): each iteration
draws a batch of them with replacement from this script's
RandomState(seed), as the JAX CLI does, for the auxiliary term and, as
their channel-mean grayscale, for the edge map or the content channel.

``video_motion`` fits a target video (a GIF, or a synthetic 16-frame
drifting texture): MSOE from ``weights/msoe.npz`` or its seeded fallback,
the target's VGG16 and MSOE features computed once, each iteration's
step_n drawn by the trainer (at least 65, so that two frames are tapped)
and the reference's tap schedule (a frame after steps 1, 65, ...), the
target window's start drawn from this script's own RandomState(seed).

Writes ``<out>/args.json`` and, at the end, ``<out>/checkpoint/state.pkl``
in the JAX package's pickle layout (``vsnca_tpu/export/checkpoint.py``:
{params, opt_state, pool, iteration} as numpy arrays), which
``convert.load_params_pickle`` reads; pool states are NCHW. Orbax
checkpoints, ``--save-every`` previews, videos and ``--dp`` are not ported
yet (ROADMAP.md A5, A9, A10).
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
    p.add_argument("--target-images", default=None,
                   help="folder of content/conditioning frames (conditioned presets)")
    p.add_argument("--target-video", default=None,
                   help="target dynamics video, a GIF (video_motion preset)")
    p.add_argument("--motion-field", default="circular",
                   help="target field of the vector_field_motion preset")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="out/run")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--no-precompute", action="store_true",
                   help="recompute the target's VGG16 (and MSOE) features every iteration")
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
        preprocess_target_images,
        preprocess_video,
        synthetic_style_image,
        synthetic_video,
    )
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
    from vsnca_tpu_torch.models.dynca import param_count
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.train.presets import PRESETS
    from vsnca_tpu_torch.train.trainer import DyNCATrainer

    device = resolve_device(args.device)
    preset_kwargs = {"img_size": args.img_size} if args.img_size else {}
    if args.preset == "vector_field_motion":
        preset_kwargs["field"] = args.motion_field
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

    target_frames = None
    if args.target_images:
        paths = sorted(os.path.join(args.target_images, f)
                       for f in os.listdir(args.target_images)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        target_frames = preprocess_target_images(paths, hw)
    elif args.preset in ("extra_channels", "edge_conditioned"):
        target_frames = synthetic_video(hw, 8)
    if target_frames is not None:
        target_frames = torch.from_numpy(target_frames).permute(0, 3, 1, 2).contiguous().to(
            device)

    target_video = None
    if args.target_video:
        target_video = preprocess_video(args.target_video, hw)
    elif args.preset == "video_motion":
        target_video = synthetic_video(hw, 16)
    if target_video is not None:
        target_video = torch.from_numpy(target_video).permute(0, 3, 1, 2).contiguous().to(device)

    vgg, vgg_pretrained = load_vgg16(device=device)
    print(f"VGG16 weights: {'pretrained' if vgg_pretrained else 'RANDOM FALLBACK'}")
    msoe = None
    if loss_cfg.vector_field_motion_weight or loss_cfg.video_motion_weight:
        from vsnca_tpu_torch.models.msoe import load_msoe

        msoe, msoe_pretrained = load_msoe(device=device)
        print(f"MSOE weights: {'pretrained' if msoe_pretrained else 'RANDOM FALLBACK'}")
    trainer = DyNCATrainer(nca_cfg, loss_cfg, train_cfg, vgg_params=vgg, msoe_params=msoe,
                           device=device)
    print(f"DyNCA param count: {param_count(trainer.params)}; device {device}")

    style_feats = None
    if loss_cfg.appearance_weight and not args.no_precompute:
        # constant across iterations: extract once
        style_feats = precompute_target_style_features(
            vgg, style, loss_cfg.appearance_loss_type, hw
        )

    motion_feats = None
    if loss_cfg.video_motion_weight and not args.no_precompute:
        from vsnca_tpu_torch.losses.video_motion import precompute_target_motion_features

        motion_feats = precompute_target_motion_features(msoe, target_video,
                                                         loss_cfg.motion_img_size)
        if motion_feats is None:
            print("skipping the motion-feature precompute: the video is past the memory "
                  "budget; the target window's features are recomputed every iteration")

    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for i in range(train_cfg.max_iterations):
        inputs = {"target_style": style}
        if style_feats is not None:
            inputs["target_style_features"] = style_feats
        if target_frames is not None:
            idx = rng.choice(target_frames.shape[0], train_cfg.batch_size, replace=True)
            aux = target_frames[torch.as_tensor(idx, device=device)]
            inputs["aux_imgs"] = aux
            inputs["aux_gs"] = aux.mean(dim=1, keepdim=True)
        iter_kw = {}
        if loss_cfg.video_motion_weight:
            from vsnca_tpu_torch.models.dynca import tap_schedule

            # the reference's schedule (fit_video_motion.py:229-235): frames
            # after steps 1, 65, ..., a frameless tail to step_n
            step_n = max(trainer.sample_step_n(), 65)
            chunks, tail = tap_schedule(step_n, 64)
            nf = len(chunks)
            iter_kw = dict(step_n=step_n, tap_chunks=chunks, tail_steps=tail)
            start = rng.randint(0, max(target_video.shape[0] - nf, 1))
            if motion_feats is not None:
                inputs["target_motion_features"] = motion_feats[start:start + nf - 1]
            else:
                window = target_video[start:start + nf]
                inputs["target_motion_frames"] = window[:, None].expand(
                    (nf, train_cfg.batch_size) + tuple(window.shape[1:]))
        sync = (i % args.log_every == 0) or (i == train_cfg.max_iterations - 1)
        log = trainer.train_iteration(inputs, sync=sync, **iter_kw)
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
