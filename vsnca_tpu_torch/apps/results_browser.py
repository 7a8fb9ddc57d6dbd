"""Static HTML results browser — the port's copy of
``vsnca_tpu/apps/results_browser.py``, the streamlit app's role
(ExtraChannels/apps/visualize_trained_models.py:18-68) without a streamlit
dependency: scans experiment output dirs and writes a self-contained
index.html with args, loss plots, step images, flow images, and videos. For
the same folder it writes the same bytes as the JAX package's.

Usage:
    python -m vsnca_tpu_torch.apps.results_browser out/ [index.html]
"""

from __future__ import annotations

import html
import json
import os
import sys
from typing import List


def _collect(exp_dir: str) -> dict:
    entry = {"name": os.path.basename(exp_dir), "path": exp_dir}
    args_path = os.path.join(exp_dir, "args.json")
    if os.path.exists(args_path):
        with open(args_path) as f:
            entry["args"] = json.load(f)
    imgs: List[str] = []
    vids: List[str] = []
    for root, _, files in os.walk(exp_dir):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), os.path.dirname(exp_dir))
            if f.lower().endswith((".png", ".jpg", ".jpeg")):
                imgs.append(rel)
            elif f.lower().endswith((".mp4", ".gif")):
                vids.append(rel)
    entry["images"] = imgs[:40]
    entry["videos"] = vids[:10]
    return entry


def build_index(out_root: str, index_path: str = None) -> str:
    index_path = index_path or os.path.join(out_root, "index.html")
    exps = [
        os.path.join(out_root, d)
        for d in sorted(os.listdir(out_root))
        if os.path.isdir(os.path.join(out_root, d))
    ]
    entries = [_collect(e) for e in exps]

    parts = [
        "<html><head><title>vsnca_tpu results</title>",
        "<style>body{font-family:sans-serif;margin:2em}"
        "img{max-width:256px;margin:4px;border:1px solid #ccc}"
        "video{max-width:320px;margin:4px}"
        "pre{background:#f4f4f4;padding:8px;max-height:260px;overflow:auto}"
        "details{margin-bottom:2em}</style></head><body>",
        f"<h1>vsnca_tpu experiments — {html.escape(out_root)}</h1>",
    ]
    for e in entries:
        parts.append(f"<details open><summary><b>{html.escape(e['name'])}</b></summary>")
        if "args" in e:
            parts.append(
                f"<pre>{html.escape(json.dumps(e['args'], indent=2)[:4000])}</pre>"
            )
        for v in e["videos"]:
            parts.append(
                f'<video controls loop src="{html.escape(v)}"></video>'
            )
        for im in e["images"]:
            parts.append(f'<img src="{html.escape(im)}" title="{html.escape(im)}">')
        parts.append("</details>")
    parts.append("</body></html>")

    with open(index_path, "w") as f:
        f.write("\n".join(parts))
    return index_path


if __name__ == "__main__":
    root = sys.argv[1] if len(sys.argv) > 1 else "out"
    idx = sys.argv[2] if len(sys.argv) > 2 else None
    print(build_index(root, idx))
