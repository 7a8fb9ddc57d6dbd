"""Video writing + the stylization drivers — the port's copy of
``vsnca_tpu/utils/video_writer.py`` (L0/L5 of SURVEY.md §1), on the port's
``infer.stylize.stylize_frames``: on the card each frame runs the rollout
kernel, ``device=None`` meaning cuda.

Parity targets: VideoWriter + save_video + evaluate_folder_of_videos +
generate_control_videos (ExtraChannels/utils/misc/video_utils.py:14-120).
Backend: OpenCV mp4 writer; GIF via PIL, picked by the file's extension.
"""

from __future__ import annotations

import os

import numpy as np


class VideoWriter:
    """Streaming frame writer: float [0,1] or uint8 HWC frames → mp4/gif."""

    def __init__(self, filename: str = "tmp.mp4", fps: float = 30.0):
        self.filename = filename
        self.fps = fps
        self._cv2_writer = None
        self._gif_frames = None
        self._is_gif = filename.lower().endswith(".gif")
        if self._is_gif:
            self._gif_frames = []

    def _to_uint8(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype in (np.float32, np.float64):
            img = np.uint8(np.clip(img, 0, 1) * 255)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        return img

    def add(self, img: np.ndarray):
        img = self._to_uint8(img)
        if self._is_gif:
            self._gif_frames.append(img)
            return
        if self._cv2_writer is None:
            import cv2

            h, w = img.shape[:2]
            os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
            self._cv2_writer = cv2.VideoWriter(
                self.filename, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h)
            )
            assert self._cv2_writer.isOpened(), f"cannot open {self.filename}"
        import cv2

        self._cv2_writer.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))

    def close(self):
        if self._cv2_writer is not None:
            self._cv2_writer.release()
            self._cv2_writer = None
        if self._is_gif and self._gif_frames:
            from PIL import Image

            frames = [Image.fromarray(f) for f in self._gif_frames]
            os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
            frames[0].save(
                self.filename, save_all=True, append_images=frames[1:],
                duration=int(1000 / self.fps), loop=0,
            )
            self._gif_frames = []

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def save_stylized_video(
    out_path: str,
    params: dict,
    nca_cfg,
    frames: np.ndarray,
    size_factor: float = 1.0,
    step_n: int = 24,
    steps_per_frame: int = 1,
    fps: float = 30.0,
    generator=None,
    device=None,
):
    """Stylize a [T, H, W, 3] in [-1, 1] frame sequence to a video file
    (video_utils.py:50-83). ``generator`` draws a random seed state (the
    stylizer's default otherwise)."""
    from vsnca_tpu_torch.infer.stylize import stylize_frames

    with VideoWriter(out_path, fps=fps) as vid:
        for frame in stylize_frames(
            params, nca_cfg, frames, step_n=step_n, steps_per_frame=steps_per_frame,
            size_factor=size_factor, generator=generator, device=device,
        ):
            vid.add(frame)
    return out_path


def evaluate_folder_of_videos(
    video_dir: str,
    save_dir: str,
    params: dict,
    nca_cfg,
    img_size=(256, 256),
    size_factor: float = 1.0,
    step_n: int = 24,
    fps: float = 30.0,
    device=None,
):
    """Stylize every mp4/gif in a folder (video_utils.py:85-99)."""
    from vsnca_tpu_torch.data.preprocess import preprocess_video

    os.makedirs(save_dir, exist_ok=True)
    vids = [f for f in sorted(os.listdir(video_dir)) if f.split(".")[-1] in ("mp4", "gif")]
    outs = []
    for v in vids:
        name = v.rsplit(".", 1)[0]
        frames = preprocess_video(
            os.path.join(video_dir, v),
            (int(img_size[0] * size_factor), int(img_size[1] * size_factor)),
        )
        outs.append(
            save_stylized_video(
                os.path.join(save_dir, f"{name}.mp4"), params, nca_cfg,
                frames, 1.0, step_n, fps=fps, device=device,
            )
        )
    return outs


def generate_control_videos(
    save_dir: str,
    params: dict,
    nca_cfg,
    style_image: np.ndarray,
    n_frames: int = 64,
    step_n: int = 24,
    fps: float = 30.0,
    device=None,
):
    """Control sanity videos (video_utils.py:101-120): the frames of
    ``infer.stylize.generate_control_frames`` — the style image itself and a
    black image as static content — written as style_img.mp4 and
    black_img.mp4. style_image: [H, W, 3] in [0, 1]."""
    from vsnca_tpu_torch.infer.stylize import generate_control_frames

    os.makedirs(save_dir, exist_ok=True)
    seqs = generate_control_frames(params, nca_cfg,
                                   (style_image * 2.0 - 1.0).astype(np.float32),
                                   n_frames, step_n, device=device)
    paths = []
    for name, frames in zip(("style_img", "black_img"), seqs):
        paths.append(os.path.join(save_dir, f"{name}.mp4"))
        with VideoWriter(paths[-1], fps=fps) as vid:
            for frame in frames:
                vid.add(frame)
    return paths
