"""Step telemetry (counterpart of dfc_sa_unet_tpu/utils/profiling.py::StepTimer)."""

import time
from typing import Optional

import torch


class StepTimer:
    """Mean step duration and throughput over the ticks of an epoch.  PyTorch
    returns before the device finishes, so with ``device`` a CUDA device each
    tick waits for it first; the trainer reads the loss every step anyway,
    which is such a wait already."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def reset(self):
        self._t_last: Optional[float] = None
        self.total_s = 0.0
        self.steps = 0
        self.items = 0

    def tick(self, items: int = 0):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._t_last is not None:
            self.total_s += now - self._t_last
            self.steps += 1
            self.items += items
        self._t_last = now

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.total_s / self.steps if self.steps else float("nan")

    @property
    def items_per_sec(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else float("nan")

    def summary(self) -> str:
        return f"{self.ms_per_step:.1f} ms/step, {self.items_per_sec:.1f} img/s"
