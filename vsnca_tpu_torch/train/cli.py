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
        [--target-video clip.mp4] [--max-iterations N] [--out out/vm]

``edge_conditioned`` and ``extra_channels`` train on content frames (a
folder of PNG/JPEG images, or 8 synthetic drifting frames): each iteration
draws a batch of them with replacement from this script's
RandomState(seed), as the JAX CLI does, for the auxiliary term and, as
their channel-mean grayscale, for the edge map or the content channel.

``video_motion`` fits a target video (a GIF, mp4 or avi, or a synthetic
16-frame drifting texture): MSOE from ``weights/msoe.npz`` or its seeded fallback,
the target's VGG16 and MSOE features computed once, each iteration's
step_n drawn by the trainer (at least 65, so that two frames are tapped)
and the reference's tap schedule (a frame after steps 1, 65, ...), the
target window's start drawn from this script's own RandomState(seed).

Writes ``<out>/args.json``, ``<out>/metrics.jsonl`` (and TensorBoard
events where ``torch.utils.tensorboard`` imports) through
``utils.logging.MetricsLogger``, and every ``--save-every`` iterations (the
preset's 50 unless given; at ``i % save_every == 0``, as the JAX CLI)
``<out>/artifacts/``: ``step_<i>.png``, a 64-step preview from a fresh seed
state, and ``loss_plot.png`` where matplotlib is installed; and
``<out>/checkpoint/state.pkl`` with ``metadata.json``, again at the end,
in the JAX CLI's pickle layout (``export/checkpoint.py``: params, Adam's
state, the pool NHWC, the iteration), which both packages read.
``--make-videos`` then writes ``<out>/videos/``: the control videos
(the style image and a black image as content, 64 frames each) and, with
``--eval-videos DIR``, every mp4/gif of DIR stylized. ``--video-only
--checkpoint DIR`` skips training and writes the videos from a checkpoint
of either package. The preview's seed state and masks come from fixed int
seeds (``PREVIEW_SEEDS``) in place of the JAX CLI's keys.

``--dp N`` trains data-parallel over N ranks (cli.py:189-203): on the card
N processes over NCCL, one a card (it raises when fewer than N cards are
visible, and never falls back to gloo or the CPU); with ``--device cpu`` N
processes over gloo. The batch and the pool must divide N. Every rank
trains ``DyNCATrainer(mesh=...)`` on its shard of the batch; rank 0 alone
prints, logs and writes the artifacts, checkpoints and videos.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
                   help="target dynamics video, GIF/mp4/avi (video_motion preset)")
    p.add_argument("--motion-field", default="circular",
                   help="target field of the vector_field_motion preset")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="out/run")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--save-every", type=int, default=None,
                   help="iterations between previews and checkpoints (the preset's otherwise)")
    p.add_argument("--video-only", action="store_true",
                   help="skip training: load --checkpoint and only generate videos")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory that --video-only reads")
    p.add_argument("--make-videos", action="store_true",
                   help="after training: control videos, and stylize the --eval-videos folder")
    p.add_argument("--eval-videos", default=None,
                   help="folder of mp4/gif to stylize into <out>/videos")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--dp", type=int, default=0, metavar="N",
                   help="data-parallel training over N ranks (0: one process); on the card "
                        "one rank a card over NCCL, with --device cpu gloo ranks")
    p.add_argument("--no-precompute", action="store_true",
                   help="recompute the target's VGG16 (and MSOE) features every iteration")
    return p.parse_args(argv)


# the preview's seed state and update masks, in place of the JAX CLI's keys
# [0, 1] and [0, 2]
PREVIEW_SEEDS = (1, 2)
PREVIEW_STEPS = 64


def checkpoint_state(trainer) -> dict:
    """The trainer's state in the JAX CLI's layout: params, Adam's state
    (``NormalizedAdam.state_arrays``), the pool NHWC, the iteration."""
    return {"params": trainer.params, "opt_state": trainer.optimizer.state_arrays(),
            "pool": trainer.pool.states.permute(0, 2, 3, 1), "iteration": trainer.iteration}


def preview(params, nca_cfg, hw, aux_gs, device) -> np.ndarray:
    """``PREVIEW_STEPS`` steps from a fresh seed state, as the JAX CLI's
    artifact dump rolls (cli.py:292-309): the content's grayscale (``aux_gs``
    [B, 1, H, W], zeros without content) appended for an extra channel and
    feeding the edge map. Returns [1, H, W, 3] in [0, 1]."""
    from vsnca_tpu_torch.models.dynca import dynca_rollout, dynca_seed, make_conditioning

    state_seed, mask_seed = PREVIEW_SEEDS
    x = dynca_seed(nca_cfg, 1, hw, torch.Generator().manual_seed(state_seed), device)
    gray = aux_gs[:1] if aux_gs is not None else torch.zeros((1, 1) + tuple(hw), device=device)
    if nca_cfg.n_seed_channels < nca_cfg.c_in:
        x = torch.cat([x, gray], dim=1)
    cond = make_conditioning(nca_cfg, hw, cond_img=gray if nca_cfg.conditioning == "edges"
                             else None, batch=1, device=device)
    with torch.no_grad():
        _, rgb = dynca_rollout(params, x, mask_seed, nca_cfg, PREVIEW_STEPS, cond)
    return ((rgb.clamp(-1.0, 1.0) + 1.0) / 2.0).permute(0, 2, 3, 1).cpu().numpy()


def write_videos(out: str, params, nca_cfg, style01: np.ndarray, hw, step_n: int,
                 eval_videos, device) -> None:
    """The control videos and, with ``eval_videos``, that folder stylized,
    into ``out/videos`` (cli.py:159-178, 336-353)."""
    from vsnca_tpu_torch.utils.video_writer import (
        evaluate_folder_of_videos,
        generate_control_videos,
    )

    video_dir = os.path.join(out, "videos")
    generate_control_videos(video_dir, params, nca_cfg, style01, step_n=step_n, device=device)
    if eval_videos:
        evaluate_folder_of_videos(eval_videos, video_dir, params, nca_cfg, hw, step_n=step_n,
                                  device=device)
    print(f"videos written to {video_dir}")


def main(argv=None):
    args = setup_args(argv)
    if args.dp and not args.video_only:
        return train_dp(args)
    return train(args)


def train_dp(args) -> None:
    """``--dp N``: N ranks, each running ``train`` with a ``data`` mesh."""
    from vsnca_tpu_torch.parallel.mesh import rank_devices, run_ranks

    device = torch.device(args.device or "cuda").type
    if device == "cuda":
        n = torch.cuda.device_count()
        if n < args.dp:
            raise RuntimeError(f"--dp {args.dp} needs {args.dp} CUDA devices, {n} visible "
                               "(NCCL takes one rank a card)")
        from vsnca_tpu_torch.ops import _build

        _build.build(_build.SOURCES)  # once, before the ranks load the kernels
    backend = "nccl" if device == "cuda" else "gloo"
    run_ranks(_train_rank, args.dp, backend, rank_devices(args.dp, device), args=(args,),
              timeout=None)


def _train_rank(device: str, args) -> None:
    from vsnca_tpu_torch.parallel.mesh import make_mesh

    args = argparse.Namespace(**{**vars(args), "device": device})
    train(args, make_mesh({"data": args.dp}))


def train(args, mesh=None) -> None:
    """The training run (or ``--video-only``) of the parsed ``args``;
    ``mesh``: this rank's data mesh under ``--dp``."""
    lead = mesh is None or mesh.index("data") == 0
    say = print if lead else (lambda *a, **k: None)

    from vsnca_tpu_torch.data.preprocess import (
        preprocess_style_image,
        preprocess_target_images,
        preprocess_video,
        synthetic_style_image,
        synthetic_video,
    )
    from vsnca_tpu_torch.convert import load_params_pickle
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.export.checkpoint import save_checkpoint
    from vsnca_tpu_torch.losses.appearance import precompute_target_style_features
    from vsnca_tpu_torch.models.dynca import param_count
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.train.presets import PRESETS
    from vsnca_tpu_torch.train.trainer import DyNCATrainer
    from vsnca_tpu_torch.utils.display import plotting_available, save_train_artifacts
    from vsnca_tpu_torch.utils.logging import MetricsLogger

    if args.checkpoint and not args.video_only:
        raise SystemExit("--checkpoint is read by --video-only only")
    if args.video_only and not args.checkpoint:
        raise SystemExit("--video-only requires --checkpoint")
    device = resolve_device(args.device)
    preset_kwargs = {"img_size": args.img_size} if args.img_size else {}
    if args.preset == "vector_field_motion":
        preset_kwargs["field"] = args.motion_field
    nca_cfg, loss_cfg, train_cfg = PRESETS[args.preset](**preset_kwargs)
    overrides = {"seed": args.seed}
    for field, value in (("max_iterations", args.max_iterations),
                         ("batch_size", args.batch_size), ("lr", args.lr),
                         ("save_every", args.save_every)):
        if value is not None:
            overrides[field] = value
    train_cfg = dataclasses.replace(train_cfg, **overrides)

    if lead:
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
    style = style * 2.0 - 1.0
    style01 = (style[0] + 1.0) / 2.0  # the control videos' style image, as the JAX CLI's
    style = torch.from_numpy(style).permute(0, 3, 1, 2).contiguous().to(device)

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

    video_steps = loss_cfg.nca_base_num_steps
    if args.video_only:
        params = load_params_pickle(args.checkpoint, device)
        write_videos(args.out, params, nca_cfg, style01, hw, video_steps, args.eval_videos,
                     device)
        return

    vgg, vgg_pretrained = load_vgg16(device=device)
    say(f"VGG16 weights: {'pretrained' if vgg_pretrained else 'RANDOM FALLBACK'}")
    msoe = None
    if loss_cfg.vector_field_motion_weight or loss_cfg.video_motion_weight:
        from vsnca_tpu_torch.models.msoe import load_msoe

        msoe, msoe_pretrained = load_msoe(device=device)
        say(f"MSOE weights: {'pretrained' if msoe_pretrained else 'RANDOM FALLBACK'}")
    trainer = DyNCATrainer(nca_cfg, loss_cfg, train_cfg, vgg_params=vgg, msoe_params=msoe,
                           device=device, mesh=mesh)
    say(f"DyNCA param count: {param_count(trainer.params)}; device {device}"
        + (f"; data-parallel over {args.dp} ranks" if mesh is not None else ""))
    plots = plotting_available()
    if train_cfg.save_every and not plots:
        say("matplotlib is not installed: the artifacts hold no loss plot")

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
            say("skipping the motion-feature precompute: the video is past the memory "
                "budget; the target window's features are recomputed every iteration")

    logger = MetricsLogger(args.out, config={"preset": args.preset}) if lead else None
    try:
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
            if sync and i % args.log_every == 0 and lead:
                rate = (i + 1) / (time.time() - t0)
                terms = " ".join(f"{k}={v:.4f}" for k, v in log.logs.items())
                print(f"iter {i:5d} loss={log.loss:.4f} {terms} ({rate:.2f} it/s)",
                      flush=True)
                logger.log_scalars(i, {"loss": log.loss, "it_per_sec": rate, **log.logs})
            if train_cfg.save_every and i % train_cfg.save_every == 0 and lead:
                save_train_artifacts(
                    os.path.join(args.out, "artifacts"), i,
                    generated=preview(trainer.params, nca_cfg, hw, inputs.get("aux_gs"), device),
                    loss_log=[float(h.loss) for h in trainer.history] if plots else None,
                )
                save_checkpoint(os.path.join(args.out, "checkpoint"), checkpoint_state(trainer),
                                metadata={"nca": dataclasses.asdict(nca_cfg)})

        if lead:
            save_checkpoint(os.path.join(args.out, "checkpoint"), checkpoint_state(trainer),
                            metadata={"nca": dataclasses.asdict(nca_cfg)})
    finally:
        if logger is not None:
            logger.close()
    say(f"done: {trainer.iteration} iterations, final loss {trainer.history[-1].loss:.4f}")
    if args.make_videos and lead:
        write_videos(args.out, trainer.params, nca_cfg, style01, hw, video_steps,
                     args.eval_videos, device)


if __name__ == "__main__":
    main()
