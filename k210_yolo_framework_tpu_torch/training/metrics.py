"""Streaming confidence-channel precision / recall.

Counterpart of ``k210_yolo_framework_tpu/training/metrics.py``: TP/FP/FN of
the confidence channel per output layer, thresholded, accumulated across
steps; results divide with div_no_nan.  The prediction is thresholded after
``sigmoid`` of its fp32 cast (the JAX package's default; its
``compat_logits`` quirk is not ported).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["init_pr_state", "update_pr_state", "pr_results",
           "pr_results_per_layer"]


def init_pr_state(n_layers: int = 1, device=None) -> Dict[str, torch.Tensor]:
    """Per-layer TP/FP/FN counters, [n_layers] fp32 each."""
    return {k: torch.zeros((n_layers,), dtype=torch.float32, device=device)
            for k in ("tp", "fp", "fn")}


@torch.no_grad()
def update_pr_state(state: Dict[str, torch.Tensor],
                    y_trues: Sequence[torch.Tensor],
                    y_preds: Sequence[torch.Tensor], thresh: float = 0.7
                    ) -> Dict[str, torch.Tensor]:
    """A new state with one batch's per-layer counts added."""
    tps, fps, fns = [], [], []
    for yt, yp in zip(y_trues, y_preds):
        pred_conf = torch.sigmoid(yp[..., 4].to(torch.float32))
        t = yt[..., 4] > thresh
        p = pred_conf > thresh
        tps.append(torch.sum((t & p).to(torch.float32)))
        fps.append(torch.sum((~t & p).to(torch.float32)))
        fns.append(torch.sum((t & ~p).to(torch.float32)))
    return {"tp": state["tp"] + torch.stack(tps),
            "fp": state["fp"] + torch.stack(fps),
            "fn": state["fn"] + torch.stack(fns)}


def _div_no_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b == 0, torch.zeros_like(a),
                       a / torch.where(b == 0, torch.ones_like(b), b))


def pr_results(state: Dict[str, torch.Tensor]):
    """(precision, recall) over all layers."""
    tp, fp, fn = (torch.sum(state[k]) for k in ("tp", "fp", "fn"))
    return _div_no_nan(tp, tp + fp), _div_no_nan(tp, tp + fn)


def pr_results_per_layer(state: Dict[str, torch.Tensor]):
    """([n_layers] precision, [n_layers] recall)."""
    tp = state["tp"]
    return (_div_no_nan(tp, tp + state["fp"]),
            _div_no_nan(tp, tp + state["fn"]))
