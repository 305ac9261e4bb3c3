"""Run-directory, logging, metric-meter, scalar-curve, EMA and profiler
utilities (counterpart of ``medsam2_tpu/utils/logging_utils.py``; rebuilds of
``func_3d/utils.py:42-82`` and ``sam2_train/modeling/utils.py:19-231``)."""

from __future__ import annotations

import datetime
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch


def set_log_dir(root_dir: str, exp_name: str) -> Dict[str, str]:
    """Create ``<root>/<exp>_<timestamp>/{Model,Log,Samples}``
    (``func_3d/utils.py:56-82`` convention)."""
    ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    prefix = os.path.join(root_dir, f"{exp_name}_{ts}")
    paths = {
        "prefix": prefix,
        "ckpt_path": os.path.join(prefix, "Model"),
        "log_path": os.path.join(prefix, "Log"),
        "sample_path": os.path.join(prefix, "Samples"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths


def create_logger(log_dir: str, phase: str = "train") -> logging.Logger:
    ts = time.strftime("%Y-%m-%d-%H-%M")
    log_file = os.path.join(log_dir, f"{phase}_{ts}.log")
    logger = logging.getLogger(log_dir)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)-15s %(message)s")
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(ch)
    return logger


class SmoothedValue:
    """Window-smoothed meter (``modeling/utils.py:19-77``)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value,
                               count=self.count)


class MetricLogger:
    """Iteration logger with per-meter smoothing (``modeling/utils.py:80-163``)."""

    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "",
                  logger: Optional[logging.Logger] = None):
        emit = logger.info if logger else print
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and i % print_freq == 0:
                total = f"/{n}" if n else ""
                emit(f"{header} [{i}{total}] iter_time: {iter_time} {self}")
            end = time.time()
        emit(f"{header} done in {time.time() - start:.1f}s {self}")


class EMA:
    """Exponential moving average of a module's parameters
    (``modeling/utils.py:166-231`` equivalent; cfg flags --model-ema*),
    kept as a name -> tensor dict under the reference keys."""

    def __init__(self, model: torch.nn.Module, decay: float = 0.99):
        self.decay = decay
        self.params = {k: p.detach().clone() for k, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: torch.nn.Module):
        d = self.decay
        for k, p in model.named_parameters():
            self.params[k].mul_(d).add_(p.detach().to(self.params[k].dtype), alpha=1.0 - d)


class Profiler:
    """``torch.profiler`` trace of the first ``num_steps`` steps, written as
    a Chrome trace ``trace.json`` under ``logdir`` (CPU and, when present,
    CUDA activity)."""

    def __init__(self, logdir: str, num_steps: int = 3):
        self.logdir = logdir
        self.num_steps = num_steps
        self._step = 0
        self._prof = None

    def step(self):
        if self._step == 0 and self.num_steps > 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self._step += 1
        if self._prof is not None and self._step >= self.num_steps:
            self.close()

    def close(self):
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
            self._prof = None


class ScalarWriter:
    """Per-step scalar-curve writer: one JSONL line per ``add_scalar`` call
    plus a rolling per-tag CSV, written under the run's Log dir.

    The reference creates a tensorboardX ``SummaryWriter`` in both CLIs
    (``train_3d.py:75``, ``train_2d.py:93``); this is the dependency-free
    counterpart — curves land in ``scalars.jsonl`` (every event) and
    ``curve_<tag>.csv`` (step,value pairs per tag) so runs can be plotted or
    diffed without tensorboard."""

    def __init__(self, log_dir: str):
        import json as _json

        os.makedirs(log_dir, exist_ok=True)
        self._json = _json
        self._path = os.path.join(log_dir, "scalars.jsonl")
        self._dir = log_dir
        self._csv_files: Dict[str, object] = {}
        self._f = open(self._path, "a", buffering=1)

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self._f.write(self._json.dumps(
            {"tag": tag, "value": value, "step": int(step),
             "time": time.time()}) + "\n")
        cf = self._csv_files.get(tag)
        if cf is None:
            safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in tag)
            cf = open(os.path.join(self._dir, f"curve_{safe}.csv"), "a",
                      buffering=1)
            if cf.tell() == 0:
                cf.write("step,value\n")
            self._csv_files[tag] = cf
        cf.write(f"{int(step)},{value}\n")

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def close(self) -> None:
        self._f.close()
        for cf in self._csv_files.values():
            cf.close()
        self._csv_files.clear()
