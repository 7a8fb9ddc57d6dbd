"""Train a DyNCA on a style image with a synthetic vector-field motion
target (BASELINE config 2), then roll the control videos — the port's
copy of ``examples/train_vector_field.py``.

Example:
    python -m vsnca_tpu_torch.examples.train_vector_field --style style.jpg \
        --field circular --iterations 2000 --out out/vf [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--style", default="synthetic")
    p.add_argument("--field", default="circular")
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--recalibrate-every", type=int, default=500,
                   help="motion_weight_change_interval: reset the vector-field weight from "
                        "median(appearance)/50 (fit_vector_field_motion.py:264-266)")
    p.add_argument("--save-every", type=int, default=500,
                   help="dump 1x/2x control videos + flow/vec-field images")
    p.add_argument("--out", default="out/vector_field")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from vsnca_tpu_torch.data.preprocess import preprocess_style_image, synthetic_style_image
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.export.checkpoint import save_checkpoint
    from vsnca_tpu_torch.models.msoe import load_msoe
    from vsnca_tpu_torch.models.vgg import load_vgg16
    from vsnca_tpu_torch.train.presets import vector_field_motion
    from vsnca_tpu_torch.train.vector_field_protocol import VectorFieldProtocol
    from vsnca_tpu_torch.utils.logging import MetricsLogger
    from vsnca_tpu_torch.utils.video_writer import generate_control_videos

    device = resolve_device(args.device)
    nca_cfg, loss_cfg, train_cfg = vector_field_motion(args.img_size, args.field)
    train_cfg = dataclasses.replace(train_cfg, max_iterations=args.iterations)

    hw = train_cfg.img_size
    if args.style == "synthetic":
        style01 = synthetic_style_image(hw, train_cfg.batch_size)
    else:
        style01 = preprocess_style_image(args.style, hw, train_cfg.batch_size)
    style = torch.from_numpy(style01 * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous().to(device)

    vgg, _ = load_vgg16(device=device)
    msoe, _ = load_msoe(device=device)
    logger = MetricsLogger(args.out)

    # the whole fit_vector_field_motion.py protocol: periodic motion-weight
    # recalibration from the appearance-loss median and periodic 1x/2x
    # control-video and flow/vec-field dumps
    proto = VectorFieldProtocol(
        nca_cfg, loss_cfg, train_cfg, style,
        recalibrate_every=args.recalibrate_every,
        save_every=args.save_every, out_dir=args.out, device=device,
    )

    def cb(phase, i, log):
        logger.log_scalars(i, {"loss": log.loss, **log.logs})
        print(f"iter {i} loss={log.loss:.4f} "
              f"vf_weight={proto.loss_cfg.vector_field_motion_weight:.3f}")

    trainer = proto.run(vgg, msoe, log_every=10, callback=cb)

    save_checkpoint(os.path.join(args.out, "checkpoint"),
                    {"params": trainer.params, "iteration": trainer.iteration})
    generate_control_videos(
        os.path.join(args.out, "videos"), trainer.params, nca_cfg,
        style01[0], step_n=loss_cfg.nca_base_num_steps, device=device,
    )
    logger.close()
    return trainer


if __name__ == "__main__":
    main()
