"""Dynamic-texture video fit with the whole fit_video_motion protocol
(BASELINE config 3): warmup, motion-weight calibration, re-init, main
phase, quantitative eval — the port's copy of
``examples/train_video_motion.py``.

Example:
    python -m vsnca_tpu_torch.examples.train_video_motion --video flames.mp4 \
        --out out/vm [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video", default="synthetic")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--iterations", type=int, default=5000)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--out", default="out/video_motion")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from vsnca_tpu_torch.data.preprocess import (
        compute_flow_strengths,
        preprocess_video,
        select_appearance_frame,
        synthetic_video,
    )
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.export.checkpoint import save_checkpoint
    from vsnca_tpu_torch.models.msoe import load_msoe
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.train.presets import video_motion
    from vsnca_tpu_torch.train.video_motion_protocol import (
        VideoMotionProtocol,
        synthesize_and_score,
    )

    device = resolve_device(args.device)
    nca_cfg, loss_cfg, train_cfg = video_motion(args.img_size)
    train_cfg = dataclasses.replace(train_cfg, max_iterations=args.iterations)

    hw = train_cfg.img_size
    if args.video == "synthetic":
        video = synthetic_video(hw, 16)
        img_name = None
    else:
        video = preprocess_video(args.video, hw)
        img_name = os.path.basename(args.video).split(".")[0]
    video = torch.from_numpy(video).permute(0, 3, 1, 2).contiguous().to(device)

    vgg, _ = load_vgg16(device=device)
    msoe, _ = load_msoe(device=device)

    # appearance frame = max-flow-strength frame (preprocess_texture.py:116-149)
    strengths = compute_flow_strengths(msoe, video)
    frame_idx = select_appearance_frame(strengths)
    style = video[frame_idx][None].expand((train_cfg.batch_size,) + tuple(video.shape[1:]))
    print(f"appearance frame: {frame_idx} (of {video.shape[0]})")

    proto = VideoMotionProtocol(
        nca_cfg, loss_cfg, train_cfg, video, style.contiguous(),
        warmup_iters=args.warmup, img_name=img_name, device=device,
    )
    trainer = proto.run(
        vgg, msoe,
        callback=lambda ph, i, log: print(f"[{ph}] {i} loss={log.loss:.4f}"),
    )

    save_checkpoint(os.path.join(args.out, "checkpoint"),
                    {"params": trainer.params, "iteration": trainer.iteration})
    scores = synthesize_and_score(trainer, video, args.out)
    print("final eval:", scores)
    return trainer, scores


if __name__ == "__main__":
    main()
