"""Training metrics: smoothed meters + logger with cross-process sync
(rebuild of croco/utils/misc.py:45-173)."""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

import numpy as np


class SmoothedValue:
    """Tracks a window-smoothed value + global avg (ref misc.py:21-86)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """all-reduce count/total across hosts (ref misc.py:45-56)."""
        import torch
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return
        from ..parallel.mesh import comm_device
        # on the device the group's backend takes: NCCL takes CUDA tensors
        arr = torch.tensor([self.count, self.total], dtype=torch.float64,
                           device=comm_device())
        dist.all_reduce(arr)
        self.count = int(arr[0])
        self.total = float(arr[1])

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with data/iter timing (ref misc.py:89-173)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i}/{total}] eta: {eta_str} {self} "
                          f"time: {iter_time} data: {data_time}")
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} "
                          f"data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{str(datetime.timedelta(seconds=int(elapsed)))}")
