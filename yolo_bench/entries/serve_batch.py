"""Entry ``serve_batch``: ``Predictor.predict_batch``, one client in a
closed loop.  Each call hands the program a pool batch of pageable host
canvases with their image sizes and takes back every image's detections on
the host, as a batch server or an mAP evaluation does; the calls cycle
through the pool.  The check holds ``sample`` pool batches (drawn from the
seed) of the window's answers to the reference."""

from __future__ import annotations

import numpy as np
import torch

from yolo_bench import serving
from yolo_bench import trace as TR


class Entry:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool):
        self.cell, self.seed, self.trace = cell, seed, trace
        self.serving = serving.Serving(cell, seed, device)
        self.pool = self.serving.host_batches()
        self.images_per_call = int(cell.traffic["batch"])
        if trace:
            TR.hook_spans(self.serving.predictor.net, "net")
        self.outputs = []
        for p in range(min(2, len(self.pool))):    # every shape is one
            self.serving.predictor.predict_batch(*self.pool[p])

    def call(self, i: int) -> None:
        p = i % len(self.pool)
        self.outputs.append(self.serving.predictor.predict_batch(
            *self.pool[p]))

    def drain(self) -> None:
        """Every call returned its answer on the host already."""

    def free(self) -> None:
        self.serving.predictor = None
        if self.serving.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """``sample`` calls on distinct pool batches, drawn from the seed
        among the window's calls; every image of each."""
        rng = np.random.default_rng(self.seed)
        pool = len(self.pool)
        batches = rng.permutation(min(pool, len(self.outputs)))
        items = []
        for p in batches[:int(self.cell.check["sample"])]:
            calls = range(int(p), len(self.outputs), pool)
            i = calls[int(rng.integers(len(calls)))]
            items += [(int(p), j, d) for j, d in enumerate(self.outputs[i])]
        got = self.detail = self.serving.compare(items)
        limits = self.cell.check["limits"]
        return {k: (got[k], float(limits[k])) for k in limits}

    def counts(self) -> dict:
        return self.serving.counts(self.images_per_call)
