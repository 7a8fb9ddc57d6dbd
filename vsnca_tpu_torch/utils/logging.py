"""Metrics/observability — the port's copy of ``vsnca_tpu/utils/logging.py``
(SURVEY.md §5.5).

``MetricsLogger`` fans out to a JSONL file (always) and TensorBoard (when
torch.utils.tensorboard is importable — flush_secs=10 like the reference
trainer.py:24-27).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(
        self,
        log_dir: str,
        use_tensorboard: bool = True,
        config: Optional[dict] = None,
    ):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(
                    os.path.join(log_dir, "tensorboard"), flush_secs=10
                )
            except ImportError:
                self._tb = None

        if config is not None:
            with open(os.path.join(log_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log_scalars(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "t": time.time() - self._t0, **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
