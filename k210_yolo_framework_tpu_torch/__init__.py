"""PyTorch/CUDA port of the YOLOv3 framework, for an NVIDIA H100.

The JAX package ``k210_yolo_framework_tpu`` is the reference this package is
held against.  Module names mirror it so each counterpart is easy to find:

    config          ``YoloSpec`` / ``voc_spec`` / ``TrainConfig`` (the
                    port's own copy of the numpy-only module)
    ops             letterbox, boxes, label codec, augment, decode, NMS
                    (the export program's plain-torch NMS and greedy
                    selection), and four kernels with their plain torch
                    versions: the fused decode+NMS head, NMS alone, the
                    fused depthwise-separable block and the augment's
                    3-shear rotation
    data            annotation lists, the JPEG loader (C++ worker threads
                    or PIL threads) and the on-device preprocess
    native          ctypes bindings of the repository's C++ loader and
                    region layer (``csrc/*.cpp``, built with g++)
    models          the four builders (yolo_mobilev1, yolo_mobilev2,
                    tiny_yolo, the darknet53 yolo), train and eval, as
                    ``nn.Module``s
    training        loss, P/R metrics, Adam train step, magnitude
                    pruning, ``fit`` (with a profiled step) and BN
                    recalibration, and checkpoints: the weight bridge
                    between the native h5 layout and torch, ``.h5`` /
                    ``.npz`` weights and the resumable train state
    inference       ``Predictor``: batched and single-image serving, fp32,
                    bf16 and the quantized modes (int8 weights; int8
                    conv compute with dynamic or calibrated activation
                    ranges)
    quantize        per-channel int8 conv kernels of a state dict
    export          ``torch.export`` programs of the raw forward and of
                    the whole serving path, and ``freeze``
    compat          ``Helper``, the reference's facade
    eval            VOC-style mAP over an annotation list, and the
                    calibration rows of the int8_act_cal mode
    anchors         kmeans anchors (1 - IoU), on the CPU
    port            reference Keras ``.h5`` files in and out
    utils           colormap, detection matching, the TensorBoard event
                    writer and the console prefixes
    cli             the command-line entry points (``python -m
                    k210_yolo_framework_tpu_torch.cli.<name>``):
                    make_voc_list, make_anchor_list, keras_train,
                    keras_inference, keras_eval, keras_freeze
    csrc            hand-written CUDA C++ kernels (built at first use)

Only ``torch`` and numpy are imported here; nothing of JAX or flax, and
nothing of the JAX package.  h5py, PIL and matplotlib are imported by the
functions that use them.
"""

from k210_yolo_framework_tpu_torch.config import (  # noqa: F401
    VOC_ANCHORS,
    YoloSpec,
    voc_spec,
)

__all__ = ["VOC_ANCHORS", "YoloSpec", "voc_spec"]
