"""Command-line entry points, each run as
``python -m k210_yolo_framework_tpu_torch.cli.<name>``, with the flags and
defaults of the JAX package's root scripts of the same name; the four that
run a net add ``--device`` (default ``cuda``; ``cpu`` for a machine
without a card, and a missing card raises):

    make_voc_list     darknet train.txt -> data/<set>_img_ann.npy
    make_anchor_list  kmeans anchors -> data/<set>_anchor.npy
    keras_train       train (pruned or not), log, save and resume
    keras_inference   one image -> the detection table and a drawn image
    keras_eval        VOC mAP over data/<set>_img_ann.npy
    keras_freeze      a checkpoint -> torch.export programs and weights

A flag whose feature the port lacks raises ``NotImplementedError`` naming
its ``ROADMAP.md`` item; it is never ignored.
"""

__all__ = ["str2bool"]


def str2bool(v) -> bool:
    """The reference passes booleans as 'True' / 'False' strings."""
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")
