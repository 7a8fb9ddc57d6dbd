"""Persistent-state video stylization — the product inference path.

Counterpart of ``vsnca_tpu/infer/stylize.py``: the NCA state persists across
frames while each frame's grayscale / edge content steers it; per frame the
cell runs ``step_n`` (default 24) steps through the rollout kernel that
``ops.fused_step.select_rollout_kernel`` picks from ``ROLLOUT_KERNELS``, as
the JAX stylizer does (stylize.py:60-63): 'flat' (``nca_step``) for a
perception_scales (0,) model, 'roll' (``nca_step_ms``) for (0, 1) at even
sizes, and eager steps where no kernel applies. The RGB readout is clipped
to [-1, 1] → [0, 1]. The state is NCHW ``[1, C, H, W]``, as on the TPU fused
path; ``state_nhwc`` gives the JAX stylizer's layout.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from vsnca_tpu_torch.config import NCAConfig
from vsnca_tpu_torch.device import resolve_device
from vsnca_tpu_torch.models.dynca import dynca_rollout, dynca_seed, make_conditioning
from vsnca_tpu_torch.ops.fused_step import ROLLOUT_KERNELS, select_rollout_kernel
from vsnca_tpu_torch.ops.resize import resize_bilinear


class VideoStylizer:
    """Streaming stylizer with persistent NCA state.

    For the ExtraChannels variant (``seed_channels < c_in``) the grayscale
    frame is appended as the last state channel and stripped after the
    rollout; for edge conditioning it feeds the edge map. The per-frame mask
    seed is the frame counter, as on the TPU fused path. ``compute_dtype``
    is the rollout kernel's matmul operand type ("bfloat16", the served
    setting, or "float32").
    """

    def __init__(
        self,
        params: dict,
        nca_cfg: NCAConfig,
        size,
        step_n: int = 24,
        generator: Optional[torch.Generator] = None,
        device=None,
        compute_dtype: str = "bfloat16",
    ):
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(v).to(self.device, torch.float32)
                       for k, v in params.items()}
        self.cfg = nca_cfg
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.step_n = step_n
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.compute_dtype = compute_dtype
        self._extra_channel = nca_cfg.n_seed_channels < nca_cfg.c_in
        self._frame_idx = 0
        self._kernel = select_rollout_kernel(nca_cfg, *self.size)
        self.reset()

    def reset(self):
        """(Re)seed the persistent state."""
        self.state = dynca_seed(self.cfg, 1, self.size, generator=self.generator,
                                device=self.device)

    @property
    def state_nhwc(self) -> torch.Tensor:
        return self.state.permute(0, 2, 3, 1)

    def damage(self, x: int, y: int, radius: int):
        """Zero a circular patch of the persistent state (the brush tool of
        the browser runtime); the NCA regenerates it over later frames."""
        yy, xx = np.ogrid[: self.size[0], : self.size[1]]
        keep = ((xx - x) ** 2 + (yy - y) ** 2 > radius**2).astype(np.float32)
        self.state = self.state * torch.from_numpy(keep).to(self.device)

    @torch.no_grad()
    def step_frame(self, frame) -> torch.Tensor:
        """Advance one content frame [1, H, W, 3] in [-1, 1] (array or
        tensor) → stylized RGB [1, H, W, 3] in [0, 1] on ``self.device``."""
        f = torch.as_tensor(frame, dtype=torch.float32).to(self.device)
        gray = f.mean(dim=-1, keepdim=True).permute(0, 3, 1, 2).contiguous()
        cond = None
        if not self._extra_channel and self.cfg.conditioning is not None:
            cond = make_conditioning(self.cfg, self.size, cond_img=gray,
                                     batch=f.shape[0])
        h = self.state
        if self._extra_channel:
            h = torch.cat([h, gray], dim=1)
        self._frame_idx += 1
        if self._kernel is None:
            out, _ = dynca_rollout(self.params, h, self._frame_idx, self.cfg, self.step_n,
                                   cond, rollout_path="xla")
        else:
            out = ROLLOUT_KERNELS[self._kernel](
                self.params, h, self._frame_idx, self.cfg, self.step_n, cond,
                compute_dtype=self.compute_dtype,
            )
        if self._extra_channel:
            out = out[:, : self.cfg.n_seed_channels].contiguous()
        self.state = out
        rgb = out[:, : self.cfg.c_out].permute(0, 2, 3, 1) * 2.0
        return (rgb.clamp(-1.0, 1.0) + 1.0) / 2.0


def stylize_frames(
    params: dict,
    nca_cfg: NCAConfig,
    frames: Sequence[np.ndarray],
    step_n: int = 24,
    steps_per_frame: int = 1,
    size_factor: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device=None,
    compute_dtype: str = "bfloat16",
) -> Iterator[np.ndarray]:
    """Stylize a frame sequence [T, H, W, 3] in [-1, 1]; yields [H, W, 3]
    arrays in [0, 1]. ``steps_per_frame=k`` emits k output frames per input
    frame; ``size_factor`` rescales the frames bilinearly first."""
    h, w = frames[0].shape[0], frames[0].shape[1]
    size = (int(h * size_factor), int(w * size_factor))
    styl = VideoStylizer(params, nca_cfg, size, step_n, generator, device,
                         compute_dtype)
    for frame in frames:
        f = torch.as_tensor(frame, dtype=torch.float32).to(styl.device)[None]
        if size != (h, w):
            f = resize_bilinear(f.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
        for _ in range(steps_per_frame):
            yield styl.step_frame(f)[0].cpu().numpy()


def generate_control_frames(
    params: dict,
    nca_cfg: NCAConfig,
    style_image: np.ndarray,
    n_frames: int = 32,
    step_n: int = 24,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """Control generations: stylize the style image itself and a black image
    as qualitative sanity checks. Returns (style_frames, black_frames)."""
    style_seq = np.repeat(style_image[None], n_frames, axis=0)
    black_seq = np.zeros_like(style_seq) - 1.0
    kw = dict(generator=generator, device=device)
    style_frames = list(stylize_frames(params, nca_cfg, style_seq, step_n, **kw))
    black_frames = list(stylize_frames(params, nca_cfg, black_seq, step_n, **kw))
    return style_frames, black_frames
