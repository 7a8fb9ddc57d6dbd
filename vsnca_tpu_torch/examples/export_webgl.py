"""Export a trained checkpoint to the WebGL JSON format and check the
quantization drift — the port's copy of ``examples/export_webgl.py``
(convert_models_to_webgl.ipynb equivalent).

Example:
    python -m vsnca_tpu_torch.examples.export_webgl out/run/checkpoint web/model.json \
        --conditioning edges [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint")
    p.add_argument("out_json")
    p.add_argument("--name", default="model")
    p.add_argument("--conditioning", default="none", choices=["none", "pos_emb", "edges"])
    p.add_argument("--c-in", type=int, default=12)
    p.add_argument("--fc-dim", type=int, default=96)
    p.add_argument("--metadata-json", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from vsnca_tpu_torch.config import NCAConfig
    from vsnca_tpu_torch.convert import load_params_pickle
    from vsnca_tpu_torch.export.webgl import save_webgl_model
    from vsnca_tpu_torch.export.webgl_sim import validate_export

    params = load_params_pickle(args.checkpoint, args.device)
    cond = None if args.conditioning == "none" else args.conditioning
    cfg = NCAConfig(c_in=args.c_in, fc_dim=args.fc_dim, conditioning=cond)

    save_webgl_model(
        args.out_json, [params], [args.name],
        pos_emb=cond == "pos_emb", edge_conditioning=cond == "edges",
        metadata_json_path=args.metadata_json, texture_name=args.name,
    )
    drift = validate_export(args.out_json, params, cfg, device=args.device)
    print(f"exported {args.out_json}")
    print(f"quantization drift: {drift}")
    return drift


if __name__ == "__main__":
    main()
