"""Command-line entry points, each run as
``python -m k210_yolo_framework_tpu_torch.cli.<name>``, with the flags and
defaults of the JAX package's root scripts of the same name; the three that
run a net add ``--device`` (default ``cuda``; ``cpu`` for a machine
without a card, and a missing card raises):

    make_voc_list     darknet train.txt -> data/<set>_img_ann.npy
    make_anchor_list  kmeans anchors -> data/<set>_anchor.npy
    keras_train       train (pruned or not), log, save and resume
    keras_inference   one image -> the detection table and a drawn image
    keras_eval        VOC mAP over data/<set>_img_ann.npy

A flag whose feature the port lacks raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item; it is never ignored.
"""

__all__ = ["str2bool", "refuse_quantize"]

_FALSE = ("false", "none", "", "0", "no")


def str2bool(v) -> bool:
    """The reference passes booleans as 'True' / 'False' strings."""
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def refuse_quantize(flag) -> None:
    """``--quantize`` off ('False', 'none', ...) passes; any mode raises."""
    if str(flag).lower() not in _FALSE:
        raise NotImplementedError(
            f"--quantize {flag!r}: quantized serving is not ported "
            "(ROADMAP.md, queue 1: quantize)")
