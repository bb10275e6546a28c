"""Reference Keras ``.h5`` weights in and out of the native layout.

Counterpart of ``k210_yolo_framework_tpu/port.py`` (a copy: the port loads
nothing of the JAX package; numpy, and h5py imported by the functions that
read or write a file).  The four layer maps pair each Keras layer name of
the reference models (TF1 Keras numbers unnamed layers in creation order)
with the native module path of the same weights; :func:`port_reference_h5`
reads a reference file into native flat paths
(``params/<module path>/kernel`` ...), which
``training.checkpoint.state_dict_from_flat`` turns into a state dict, and
:func:`save_reference_h5` writes native flat paths back in the reference
layout.  Keras depthwise kernels are [kh, kw, C, 1] where the native layout
has [kh, kw, 1, C]; dense kernels are HWIO in both.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np

__all__ = [
    "mobilev1_layer_map",
    "mobilev2_layer_map",
    "tiny_yolo_layer_map",
    "yolo_layer_map",
    "port_reference_h5",
    "save_reference_h5",
]

_BN_WEIGHTS = [("gamma:0", "params", "scale"), ("beta:0", "params", "bias"),
               ("moving_mean:0", "batch_stats", "mean"),
               ("moving_variance:0", "batch_stats", "var")]


def _dw_transpose(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (0, 1, 3, 2))


def mobilev1_layer_map() -> List[Tuple[str, str, List]]:
    """[(keras_layer, our_module_path, weight specs)] for yolo_mobilev1.

    Weight spec: (keras_weight_name, collection, our_leaf_name[, transform]).
    """
    table: List[Tuple[str, str, List]] = [
        ("conv1", "backbone/stem/conv", [("kernel:0", "params", "kernel")]),
        ("conv1_bn", "backbone/stem/bn", list(_BN_WEIGHTS)),
    ]
    for n in range(1, 14):
        table += [
            (f"conv_dw_{n}", f"backbone/block_{n}/dw/conv",
             [("depthwise_kernel:0", "params", "kernel", _dw_transpose)]),
            (f"conv_dw_{n}_bn", f"backbone/block_{n}/dw/bn", list(_BN_WEIGHTS)),
            (f"conv_pw_{n}", f"backbone/block_{n}/pw/conv",
             [("kernel:0", "params", "kernel")]),
            (f"conv_pw_{n}_bn", f"backbone/block_{n}/pw/bn", list(_BN_WEIGHTS)),
        ]
    table += _head_rows(conv_start=0, bn_start=0)
    return table


def _head_rows(conv_start: int, bn_start: int) -> List[Tuple[str, str, List]]:
    """The auto-numbered 2-scale head shared by the mobilenet/tiny builders
    (the reference's yolonet.py).  Keras numbers Conv2D/BatchNorm
    layers in creation order: y1 3x3+BN, y1 out, up 1x1+BN, y2 3x3+BN,
    y2 out."""
    def conv(i):
        return "conv2d" if i == 0 else f"conv2d_{i}"

    def bn(i):
        return "batch_normalization" if i == 0 else f"batch_normalization_{i}"

    c, b = conv_start, bn_start
    return [
        (conv(c), "head/y1_conv/dark_conv_bn/conv", [("kernel:0", "params", "kernel")]),
        (bn(b), "head/y1_conv/dark_conv_bn/bn", list(_BN_WEIGHTS)),
        (conv(c + 1), "head/y1_out/dark_conv_out",
         [("kernel:0", "params", "kernel"), ("bias:0", "params", "bias")]),
        (conv(c + 2), "head/up_conv/dark_conv_bn/conv", [("kernel:0", "params", "kernel")]),
        (bn(b + 1), "head/up_conv/dark_conv_bn/bn", list(_BN_WEIGHTS)),
        (conv(c + 3), "head/y2_conv/dark_conv_bn/conv", [("kernel:0", "params", "kernel")]),
        (bn(b + 2), "head/y2_conv/dark_conv_bn/bn", list(_BN_WEIGHTS)),
        (conv(c + 4), "head/y2_out/dark_conv_out",
         [("kernel:0", "params", "kernel"), ("bias:0", "params", "bias")]),
    ]


def mobilev2_layer_map() -> List[Tuple[str, str, List]]:
    """yolo_mobilev2: keras-applications MobileNetV2 names (the reference's
    keras_mobilenet_v2.py) + the auto-numbered head.

    Block 0 is named ``expanded_conv_*`` and has no expand conv; blocks
    1-16 are ``block_{n}_{expand,depthwise,project}`` (+``_BN``).
    """
    table: List[Tuple[str, str, List]] = [
        ("Conv1", "backbone/stem/conv", [("kernel:0", "params", "kernel")]),
        ("bn_Conv1", "backbone/stem/bn", list(_BN_WEIGHTS)),
        ("expanded_conv_depthwise", "backbone/block_0/depthwise/conv",
         [("depthwise_kernel:0", "params", "kernel", _dw_transpose)]),
        ("expanded_conv_depthwise_BN", "backbone/block_0/depthwise/bn", list(_BN_WEIGHTS)),
        ("expanded_conv_project", "backbone/block_0/project/conv",
         [("kernel:0", "params", "kernel")]),
        ("expanded_conv_project_BN", "backbone/block_0/project/bn", list(_BN_WEIGHTS)),
    ]
    for n in range(1, 17):
        table += [
            (f"block_{n}_expand", f"backbone/block_{n}/expand/conv",
             [("kernel:0", "params", "kernel")]),
            (f"block_{n}_expand_BN", f"backbone/block_{n}/expand/bn", list(_BN_WEIGHTS)),
            (f"block_{n}_depthwise", f"backbone/block_{n}/depthwise/conv",
             [("depthwise_kernel:0", "params", "kernel", _dw_transpose)]),
            (f"block_{n}_depthwise_BN", f"backbone/block_{n}/depthwise/bn", list(_BN_WEIGHTS)),
            (f"block_{n}_project", f"backbone/block_{n}/project/conv",
             [("kernel:0", "params", "kernel")]),
            (f"block_{n}_project_BN", f"backbone/block_{n}/project/bn", list(_BN_WEIGHTS)),
        ]
    table += [
        ("Conv_1", "backbone/conv_last/conv", [("kernel:0", "params", "kernel")]),
        ("Conv_1_bn", "backbone/conv_last/bn", list(_BN_WEIGHTS)),
    ]
    table += _head_rows(conv_start=0, bn_start=0)
    return table


def tiny_yolo_layer_map() -> List[Tuple[str, str, List]]:
    """tiny_yolo: every layer is auto-numbered.

    Body creation order: conv2d..conv2d_7 = the 16/32/64/128/256/512/1024/
    256(1x1) ladder (our ``backbone/conv_0..7``), then the shared head at
    conv2d_8 / batch_normalization_8.
    """
    table: List[Tuple[str, str, List]] = []
    for i in range(8):
        conv = "conv2d" if i == 0 else f"conv2d_{i}"
        bn = "batch_normalization" if i == 0 else f"batch_normalization_{i}"
        table += [
            (conv, f"backbone/conv_{i}/dark_conv_bn/conv",
             [("kernel:0", "params", "kernel")]),
            (bn, f"backbone/conv_{i}/dark_conv_bn/bn", list(_BN_WEIGHTS)),
        ]
    table += _head_rows(conv_start=8, bn_start=8)
    return table


def yolo_layer_map() -> List[Tuple[str, str, List]]:
    """Full yolo: darknet53 + 3 last-layer stacks, all auto-numbered.

    Conv creation order: stem, then each resblock (down conv then
    num_blocks x [1x1, 3x3]) = conv2d..conv2d_51 with matching BNs; then
    make_last_layers(512) trunk 0-4 / branch / out = conv2d_52..58 (BN
    52-57), up1 conv2d_59 (BN 58), make_last_layers(256) = conv2d_60..66
    (BN 59-64), up2 conv2d_67 (BN 65), make_last_layers(128) =
    conv2d_68..74 (BN 66-72).  Out convs carry a bias and no BN, so the
    BN counter lags the conv counter after conv2d_58.
    """
    counters = {"conv": 0, "bn": 0}

    def conv_bn(path: str) -> List[Tuple[str, str, List]]:
        c, b = counters["conv"], counters["bn"]
        conv = "conv2d" if c == 0 else f"conv2d_{c}"
        bn = "batch_normalization" if b == 0 else f"batch_normalization_{b}"
        counters["conv"], counters["bn"] = c + 1, b + 1
        return [
            (conv, f"{path}/dark_conv_bn/conv", [("kernel:0", "params", "kernel")]),
            (bn, f"{path}/dark_conv_bn/bn", list(_BN_WEIGHTS)),
        ]

    def out_conv(path: str) -> List[Tuple[str, str, List]]:
        c = counters["conv"]
        conv = "conv2d" if c == 0 else f"conv2d_{c}"
        counters["conv"] = c + 1
        return [(conv, f"{path}/dark_conv_out",
                 [("kernel:0", "params", "kernel"), ("bias:0", "params", "bias")])]

    table: List[Tuple[str, str, List]] = []
    table += conv_bn("backbone/stem")
    for stage, nblocks in [(1, 1), (2, 2), (3, 8), (4, 8), (5, 4)]:
        table += conv_bn(f"backbone/stage_{stage}/down")
        for i in range(nblocks):
            table += conv_bn(f"backbone/stage_{stage}/res_{i}_1x1")
            table += conv_bn(f"backbone/stage_{stage}/res_{i}_3x3")
    for scale, up in [("512", "up1_conv"), ("256", "up2_conv"), ("128", None)]:
        for i in range(5):
            table += conv_bn(f"last_{scale}/trunk_{i}")
        table += conv_bn(f"last_{scale}/branch")
        yi = {"512": "y1", "256": "y2", "128": "y3"}[scale]
        table += out_conv(f"{yi}_out")
        if up is not None:
            table += conv_bn(up)
    return table


_LAYER_MAPS = {
    "yolo_mobilev1": mobilev1_layer_map,
    "yolo_mobilev2": mobilev2_layer_map,
    "tiny_yolo": tiny_yolo_layer_map,
    "yolo": yolo_layer_map,
}

# How shape mismatches between donor weights and our template are resolved,
# mirroring the reference's transplant semantics per model:
#   exact      — any mismatch is an error (the mobilenet backbones);
#   slice_cout — a COCO 255-channel head sliced to the first a*(5+C) output
#                channels (tiny_yolo);
#   min_shape  — elementwise min-shape partial copy into the current values
#                (the darknet53 transplant).
_PORT_POLICIES = {
    "yolo_mobilev1": "exact",
    "yolo_mobilev2": "exact",
    "tiny_yolo": "slice_cout",
    "yolo": "min_shape",
}


def _find_layer_group(f, layer: str):
    """Keras h5 stores weights under model_weights/<layer>/<layer>/<w> (full
    saves) or <layer>/<layer>/<w> (save_weights)."""
    root = f["model_weights"] if "model_weights" in f else f
    if layer not in root:
        return None
    g = root[layer]
    return g[layer] if layer in g else g


def _get_weight(g, wname: str) -> np.ndarray:
    """Fetch one weight, tolerating both h5 naming eras: TF1 Keras writes
    ``kernel:0``/``depthwise_kernel:0``; Keras 3's legacy-h5 writer drops the
    ``:0`` suffix and stores depthwise kernels as plain ``kernel`` (same
    [kh, kw, C, 1] layout)."""
    candidates = [wname]
    if wname.endswith(":0"):
        candidates.append(wname[:-2])
    if wname.startswith("depthwise_kernel"):
        candidates.append("kernel")
    for c in candidates:
        if c in g:
            return np.asarray(g[c])
    raise KeyError(f"none of {candidates} found in layer group {g.name}; "
                   f"has {list(g)}")


def _set_leaf(flat: Dict[str, np.ndarray], key: str, value: np.ndarray,
              policy: str = "exact") -> None:
    leaf = np.asarray(flat[key])
    if tuple(leaf.shape) != tuple(value.shape):
        if policy == "slice_cout" and (
                value.ndim == leaf.ndim
                and value.shape[:-1] == leaf.shape[:-1]
                and value.shape[-1] >= leaf.shape[-1]):
            # a COCO 255-channel head -> the first anchor_num*(5+C) channels
            value = value[..., :leaf.shape[-1]]
        elif policy == "min_shape" and value.ndim == leaf.ndim:
            # partial transplant: the overlapping hyperrectangle, the
            # current values elsewhere
            sl = tuple(slice(0, min(a, b))
                       for a, b in zip(leaf.shape, value.shape))
            out = leaf.copy()
            out[sl] = value[sl]
            value = out
        else:
            raise ValueError(f"{key}: reference weight shape {value.shape} "
                             f"!= ours {tuple(leaf.shape)}")
    flat[key] = value.astype(leaf.dtype)


def _table(model_def: str) -> List[Tuple[str, str, List]]:
    if model_def not in _LAYER_MAPS:
        raise KeyError(f"no reference layer map for {model_def!r}; "
                       f"have {sorted(_LAYER_MAPS)}")
    return _LAYER_MAPS[model_def]()


def save_reference_h5(h5_path: str, flat: Mapping[str, np.ndarray],
                      model_def: str) -> None:
    """Write native flat weights (``training.checkpoint.
    flat_from_state_dict``) as a reference-layout Keras ``.h5``, the inverse
    of :func:`port_reference_h5`: the ``save_weights`` flavour, a root
    ``layer_names`` attribute in Keras's depth-sorted ``model.layers``
    order (its plain loader pairs layers by position), one group per layer
    with a ``weight_names`` attribute, datasets at
    ``<layer>/<layer>/<weight>:0``, fp32, depthwise kernels back in Keras's
    [kh, kw, C, 1]."""
    import h5py

    table = _table(model_def)
    with h5py.File(h5_path, "w") as f:
        f.attrs["layer_names"] = np.array(
            [n.encode("utf8") for n in
             _keras_layer_order(model_def, [r[0] for r in table])])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.2.4-tf"
        for layer, module_path, weights in table:
            g = f.create_group(layer)
            names = []
            for spec in weights:
                wname, coll, leaf = spec[0], spec[1], spec[2]
                transform = spec[3] if len(spec) > 3 else None
                arr = np.asarray(flat[f"{coll}/{module_path}/{leaf}"])
                if transform is _dw_transpose:
                    arr = _dw_transpose(arr)  # an involution
                elif transform is not None:
                    raise NotImplementedError(
                        f"no inverse registered for transform {transform}")
                full = f"{layer}/{wname}"
                g.create_dataset(full, data=np.asarray(arr, np.float32))
                names.append(full.encode("utf8"))
            g.attrs["weight_names"] = np.array(names)


def port_reference_h5(h5_path: str, model_def: str,
                      template: Mapping[str, np.ndarray],
                      allow_missing: bool = True
                      ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """A reference Keras ``.h5`` -> (native flat weights, missing layers).

    ``template`` (native flat paths, e.g. ``flat_from_state_dict`` of the
    net) gives the shapes and the values of the layers the file lacks;
    shape mismatches follow the model's policy (exact for the mobilenet
    builders, the first output channels of a wider head for tiny_yolo, the
    overlap for yolo).  With ``allow_missing`` (the default) absent layers
    (a backbone-only file, or a file with none of the map's layers) keep
    the template's values and are listed in ``missing``; with
    ``allow_missing=False`` any absent layer raises ``KeyError``.
    """
    import h5py

    table = _table(model_def)
    policy = _PORT_POLICIES[model_def]
    out = {k: np.array(v, copy=True) for k, v in template.items()}
    missing: List[str] = []
    with h5py.File(h5_path, "r") as f:
        for layer, module_path, weights in table:
            g = _find_layer_group(f, layer)
            if g is None:
                missing.append(layer)
                continue
            for spec in weights:
                wname, coll, leaf = spec[0], spec[1], spec[2]
                transform = spec[3] if len(spec) > 3 else None
                arr = _get_weight(g, wname)
                if transform is not None:
                    arr = transform(arr)
                _set_leaf(out, f"{coll}/{module_path}/{leaf}", arr, policy)
    if missing and not allow_missing:
        raise KeyError(f"layers missing from {h5_path}: {missing}")
    return out, missing


def _keras_layer_order(model_def: str, names: List[str]) -> List[str]:
    """Reorder creation-order layer names into Keras's ``model.layers``
    order (weighted layers only).

    Keras's functional ``load_weights`` (non-``by_name``) pairs the file's
    layers with ``model.layers`` BY POSITION, and ``model.layers`` is sorted
    by graph depth (deepest first; creation order breaks ties), not by
    creation order — so the multi-branch heads deviate: the upsample branch
    is deeper than the y1 branch and sorts before it, and in the 3-scale
    head the three branch/out stacks interleave by depth.  These
    permutations were derived from genuine tf.keras builds of all four
    graphs and are pinned by the JAX package's tests
    (``tests/test_reference_export.py``).
    """
    if model_def in ("yolo_mobilev1", "yolo_mobilev2", "tiny_yolo"):
        # creation order (_head_rows): y1c, y1bn, y1out, upc, upbn, y2c,
        # y2bn, y2out -> depth order: up branch, 3x3 convs, BNs, out convs
        y1c, y1bn, y1out, upc, upbn, y2c, y2bn, y2out = names[-8:]
        return names[:-8] + [upc, upbn, y1c, y2c, y1bn, y2bn, y1out, y2out]
    if model_def == "yolo":
        body, tail = names[:104], names[104:]
        t512, br512, y1, up1 = tail[0:10], tail[10:12], tail[12], tail[13:15]
        t256, br256, y2, up2 = tail[15:25], tail[25:27], tail[27], tail[28:30]
        t128, br128, y3 = tail[30:40], tail[40:42], tail[42]
        return (body + t512 + up1 + t256 + up2 + t128
                + [br512[0], br256[0], br128[0],
                   br512[1], br256[1], br128[1], y1, y2, y3])
    raise KeyError(model_def)
