"""What the two serving entries share: the program's Predictor made from the
cell's configuration and weights, the reference's detections for a batch,
and the FLOP and byte counts the per-layer readers divide by."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from yolo_bench import compare, counts, traffic, weights
from yolo_bench.reference import nets as RN
from yolo_bench.reference import serve as RS


def anchors_of(cfg: dict) -> np.ndarray:
    return np.asarray(cfg["anchors"], np.float32)


class Serving:
    """Set-up common to the serving entries: inputs, weights (calibrated
    on the first pool batch), the reference net that holds them and its
    decode, and the program's ``Predictor`` serving them in the
    configuration's dtype."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.inputs = traffic.make(tr, seed, device)
        self.ref = RN.build(cfg["model_def"], cfg["anchors_per_layer"],
                            cfg["classes"], cfg.get("alpha", 1.0)).to(device)
        # the builder file's decode where it has one (nets.builder_file)
        self.decode = getattr(RN.builder_file(cfg["model_def"]), "decode",
                              RS.decode)
        weights.make_state(self.ref, cfg, seed * 8, device)
        n = int(cfg["weights"]["calibration_images"])
        weights.calibrate(self.ref, cfg, self.inputs["canvases"][0][:n],
                          self.inputs["img_hws"][0][:n])
        self.predictor = self._predictor(weights.state_of(self.ref))

    def _predictor(self, state: Dict[str, torch.Tensor]):
        from k210_yolo_framework_tpu_torch.config import YoloSpec
        from k210_yolo_framework_tpu_torch.inference import Predictor
        from k210_yolo_framework_tpu_torch.models import build_network

        cfg, tr = self.cell.config, self.cell.traffic
        spec = YoloSpec.create(cfg["in_hw"], cfg["out_hws"], cfg["classes"],
                               anchors_of(cfg))
        net = build_network(cfg["model_def"], spec.in_hw, spec.nanchors,
                            spec.class_num, alpha=cfg.get("alpha", 1.0),
                            generator=torch.Generator().manual_seed(0))
        dtype = getattr(torch, cfg["precision"])
        return Predictor(net, state, spec, obj_thresh=tr["obj_thresh"],
                         iou_thresh=tr["iou_thresh"], max_out=tr["max_out"],
                         compute_dtype=dtype,
                         quantize=cfg.get("serve_quantize"),
                         device=self.device)

    def host_batches(self) -> List[tuple]:
        """The pool as the host hands it to ``predict_batch``: pageable
        numpy canvases and sizes."""
        c = self.inputs["canvases"].cpu().numpy()
        h = self.inputs["img_hws"].cpu().numpy()
        return [(c[p], h[p]) for p in range(len(c))]

    @torch.no_grad()
    def reference(self, p: int, idx: torch.Tensor):
        """The reference's candidates and detections for images ``idx`` of
        pool batch ``p``: (boxes [k, N, 4], scores [k, N, C], per-image
        detections, live candidate tests)."""
        RN.ensure_fp32()
        cfg, tr = self.cell.config, self.cell.traffic
        canv = self.inputs["canvases"][p][idx]
        hws = self.inputs["img_hws"][p][idx]
        images = RS.unit_scale(RS.letterbox(
            canv, hws, cfg["in_hw"], getattr(torch, cfg["precision"])))
        logits = RN.forward(self.ref, images, cfg["anchors_per_layer"])
        boxes, scores = self.decode(logits, anchors_of(cfg), cfg["in_hw"],
                                    hws)
        kept, live = RS.nms(boxes, scores, tr["obj_thresh"],
                            tr["iou_thresh"], tr["max_out"])
        return boxes, scores, RS.detections(boxes, scores, kept), live

    def compare(self, items: Sequence[tuple]) -> dict:
        """Hold served answers, ``items`` of (pool batch, image, its
        detections), to the reference's, in blocks of ``ref_block``
        images; also keeps the live tests the head needs an image (their
        mean over the items) for :meth:`counts`."""
        block = int(self.cell.check["ref_block"])
        tr = self.cell.traffic
        by_batch: Dict[int, list] = {}
        for p, j, dets in items:
            by_batch.setdefault(p, []).append((j, dets))
        results, live = [], 0
        for p, rows in sorted(by_batch.items()):
            for lo in range(0, len(rows), block):
                part = rows[lo:lo + block]
                idx = torch.tensor([j for j, _ in part], device=self.device)
                boxes, scores, dets, n = self.reference(p, idx)
                results.append(compare.detections(
                    [d for _, d in part], boxes, scores, dets,
                    self.inputs["img_hws"][p][idx],
                    float(self.cell.check["match_tau"]), tr["obj_thresh"],
                    tr["iou_thresh"], tr["max_out"]))
                live += n
        self.live_per_image = live / len(items)
        return compare.merge(results)

    def counts(self, images_per_call: int) -> dict:
        cfg, tr = self.cell.config, self.cell.traffic
        n = sum(h * w for h, w in cfg["out_hws"]) * cfg["anchors_per_layer"]
        return {"forward_flops_per_image": counts.forward_flops(cfg),
                "head": counts.head_work(
                    images_per_call, n, cfg["classes"], tr["max_out"],
                    getattr(self, "live_per_image", 0) * images_per_call)}
