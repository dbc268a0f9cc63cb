"""Structured metrics + console logging (counterpart of ``pcgan_tpu/utils/metrics.py:17-85``).

The reference's ``print_current_losses`` console line, plus one JSON object
per logged step in ``metrics.jsonl`` (losses, images/s, lr, wall time),
mirrored into a TensorBoard event file under ``--tb_logdir``
(``utils/tb_writer.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 echo: bool = True, tb_logdir: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self.echo = echo
        self._t0 = time.time()
        self._tb = None
        if tb_logdir:
            from pcgan_tpu_torch.utils.tb_writer import TBWriter
            self._tb = TBWriter(tb_logdir)

    def log(self, step: int, metrics: Dict[str, float], epoch: int = None,
            imgs_per_sec: float = None, lr: float = None):
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        rec.update({k: float(v) for k, v in metrics.items()})
        if imgs_per_sec is not None:
            rec["imgs_per_sec"] = round(float(imgs_per_sec), 2)
        if lr is not None:
            rec["lr"] = float(lr)
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            scalars = {k: float(v) for k, v in metrics.items()}
            if imgs_per_sec is not None:
                scalars["imgs_per_sec"] = float(imgs_per_sec)
            if lr is not None:
                scalars["lr"] = float(lr)
            self._tb.add_scalars(step, scalars)
        if self.echo:
            # reference console line:
            # (epoch: E, iters: N, imgs/s: r) loss_G: x loss_D: y ...
            parts = [f"{k}: {float(v):.3f}" for k, v in metrics.items()]
            head = f"(epoch: {epoch}, iters: {step}" if epoch is not None \
                else f"(iters: {step}"
            if imgs_per_sec is not None:
                head += f", imgs/s: {imgs_per_sec:.1f}"
            print(head + ") " + " ".join(parts), flush=True)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Images per second between ``start()`` and ``rate()``; the caller
    synchronizes the device before reading the rate (the print point's
    metric fetch does)."""

    def __init__(self):
        self._t = None
        self._images = 0

    def start(self):
        self._t = time.perf_counter()
        self._images = 0

    def tick(self, n_images: int):
        self._images += n_images

    def rate(self) -> Optional[float]:
        if self._t is None or self._images == 0:
            return None
        dt = time.perf_counter() - self._t
        return self._images / dt if dt > 0 else None
