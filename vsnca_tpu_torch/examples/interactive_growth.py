"""Interactive-grower demo — the port's copy of
``examples/interactive_growth.py`` (visualisation.ipynb equivalent): grow
toward a goal, damage the centre, regenerate, switch goals, dump a frame
strip.

Example:
    python -m vsnca_tpu_torch.examples.interactive_growth \
        --checkpoint out/encoder/checkpoint [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--out", default="out/growth")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from vsnca_tpu_torch.config import ConditionedNCAConfig
    from vsnca_tpu_torch.convert import load_params_pickle
    from vsnca_tpu_torch.data.preprocess import synthetic_video
    from vsnca_tpu_torch.device import resolve_device
    from vsnca_tpu_torch.infer.grower import InteractiveGrower
    from vsnca_tpu_torch.models.conditioned_nca import conditioned_nca_init
    from vsnca_tpu_torch.utils.display import save_image_grid

    device = resolve_device(args.device)
    s = args.image_size
    cfg = ConditionedNCAConfig(image_size=s)
    if args.checkpoint:
        params = load_params_pickle(args.checkpoint, device)
    else:
        params = conditioned_nca_init(torch.Generator().manual_seed(0), cfg, device)

    goals = synthetic_video((s, s), 2)
    g = InteractiveGrower(params, cfg, goals[0:1], device=device)

    frames = [g.step(16) for _ in range(4)]  # grow
    g.damage(s // 2, s // 2, radius=s // 8)  # damage the centre
    frames.append(g.rgb())
    frames += [g.step(16) for _ in range(2)]  # regenerate
    g.set_goal(goals[1:2])  # switch goal
    frames += [g.step(16) for _ in range(2)]

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "growth_strip.png")
    save_image_grid(np.stack(frames), path)
    print(f"wrote {path} ({len(frames)} stages)")
    return path


if __name__ == "__main__":
    main()
