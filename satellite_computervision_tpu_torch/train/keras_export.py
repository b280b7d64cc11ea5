"""Export a model of the port to the reference's Keras ``.h5`` layout.

Port of ``satellite_computervision_tpu/train/keras_export.py``, the inverse
of :mod:`train.keras_import` for every importable family: U-Net, Siamese
change detection, LSTM, LSTM autoencoder and hybrid. Each exporter reads
the model's weights in the flax layout (``models.bridge.torch_to_flax``)
and writes them as a Keras-2 ``save_weights``-format HDF5 file, layer for
layer and array for array what the JAX exporter writes for the same
weights, so that

- :mod:`train.keras_import` (and the JAX package's importer) reads it back
  bit for bit, and
- a tf.keras reference model loads it with ``model.load_weights(path)``:
  Keras' legacy-HDF5 loader matches layers topologically and expects each
  layer's ``weight_names`` trainable first, then non-trainable, which is
  the order written here.

Tensor conventions are the inverses of keras_import's: conv kernels HWIO
pass through, ConvTranspose kernels are flipped in space and (in, out) ->
(out, in) transposed (an involution), BatchNorm scale/bias/mean/var ->
gamma/beta/moving_mean/moving_variance, and a ConvLSTM's forget quarter of
the bias gets Keras's unit forget bias (+1) back.

Two faults of the JAX exporter are not repeated here:

- a Siamese U-Net with four or more convs per block would write encoder
  groups that the importer (both packages') reads as the ASPP: refused
  with a ``ValueError``;
- a model without BatchNorm running statistics (``track_running_stats=
  False``), like a folded serving tree, has nothing to write for
  moving_mean/moving_variance: a ``ValueError`` that says to export the
  training checkpoint, where the JAX exporter raised a bare ``KeyError``.

``h5py`` is imported when a file is written.
"""

from __future__ import annotations

import io
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch.models.bridge import torch_to_flax

__all__ = [
    "export_keras_unet_h5",
    "export_keras_unet_h5_bytes",
    "export_keras_siamese_h5",
    "export_keras_siamese_h5_bytes",
    "export_keras_lstm_h5",
    "export_keras_lstm_autoencoder_h5",
    "export_keras_hybrid_h5",
    "keras_unet_layers",
    "keras_siamese_layers",
    "keras_lstm_layers",
    "keras_lstm_autoencoder_layers",
    "keras_hybrid_layers",
]

Weights = List[Tuple[str, np.ndarray]]
Layers = List[Tuple[str, Weights]]

_NOT_EXPORTABLE = ("no BatchNorm statistics — folded (fold_bn) serving models are not "
                   "exportable; export the training checkpoint")


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


class _Names:
    """Keras-style global auto-numbering: first instance bare, then _1…"""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def next(self, base: str) -> str:
        n = self.counts.get(base, 0)
        self.counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"


def _node(tree: Mapping, where: str, *keys):
    """``tree[k0][k1]...``; a missing entry is the folded / statistics-free
    case, a ``ValueError``."""
    for k in keys:
        if not isinstance(tree, Mapping) or k not in tree:
            raise ValueError(f"{where}: {_NOT_EXPORTABLE}")
        tree = tree[k]
    return tree


def _conv_weights(parent: str, p) -> Weights:
    out = [(f"{parent}/kernel:0", _np(p["kernel"]))]
    if "bias" in p:
        out.append((f"{parent}/bias:0", _np(p["bias"])))
    return out


def _conv_transpose_weights(parent: str, p) -> Weights:
    # inverse of keras_import._conv_transpose_params — the same flip and
    # (…, in, out) <-> (…, out, in) swap (it is its own inverse)
    k = _np(p["kernel"])[::-1, ::-1].transpose(0, 1, 3, 2).copy()
    out = [(f"{parent}/kernel:0", k)]
    if "bias" in p:
        out.append((f"{parent}/bias:0", _np(p["bias"])))
    return out


def _bn_weights(parent: str, p, s, where: str):
    trainable = [
        (f"{parent}/gamma:0", _np(p["scale"])),
        (f"{parent}/beta:0", _np(p["bias"])),
    ]
    stats = [
        (f"{parent}/moving_mean:0", _np(_node(s, where, "mean"))),
        (f"{parent}/moving_variance:0", _np(_node(s, where, "var"))),
    ]
    return trainable, stats


def _cba_block_weights(lname: str, names: _Names, p_block, s_block) -> Weights:
    """One ConvBlock (ConvBNAct_i subtrees) as a single Keras Layer group:
    weight_names trainable-first across the block (Keras ``_legacy_weights``
    order), nested paths containing conv_batch_act so keras_import
    recognizes the group as an encoder/center block."""
    n_cba = len([k for k in p_block if k.startswith("ConvBNAct_")])
    if n_cba == 0:
        raise ValueError(f"{lname}: no ConvBNAct_* subtrees — not a UNet ConvBlock tree")
    trainable: Weights = []
    non_trainable: Weights = []
    inner_cb = names.next("conv_block")
    for i in range(n_cba):
        where = f"{lname}/ConvBNAct_{i}"
        sub_p = p_block[f"ConvBNAct_{i}"]
        if "BatchNorm_0" not in sub_p:
            raise ValueError(f"{where}: {_NOT_EXPORTABLE}")
        cba = names.next("conv_batch_act")
        conv = names.next("conv2d")
        bn = names.next("batch_normalization")
        pfx = f"{lname}/{inner_cb}/{cba}"
        trainable.extend(_conv_weights(f"{pfx}/{conv}", sub_p["Conv_0"]))
        bn_train, bn_stats = _bn_weights(
            f"{pfx}/{bn}", sub_p["BatchNorm_0"],
            _node(s_block, where, f"ConvBNAct_{i}", "BatchNorm_0"), where)
        trainable.extend(bn_train)
        non_trainable.extend(bn_stats)
    return trainable + non_trainable


def _append_decoder_layers(layers: Layers, names: _Names, dec: str, p, s) -> None:
    """One functional decoder level (utils/model_tools.py:288-318) as flat
    Keras layers: conv2d_transpose, bn, (conv, bn) x2."""
    if "affine_0_scale" in p or "BatchNorm_0" not in p:
        raise ValueError(f"{dec}: {_NOT_EXPORTABLE}")
    ct = names.next("conv2d_transpose")
    layers.append((ct, _conv_transpose_weights(ct, p["ConvTranspose_0"])))
    for unit in range(3):  # bn, then (conv, bn) x2 per decoder level
        if unit > 0:
            conv = names.next("conv2d")
            layers.append((conv, _conv_weights(conv, p[f"Conv_{unit - 1}"])))
        bn = names.next("batch_normalization")
        bn_train, bn_stats = _bn_weights(bn, p[f"BatchNorm_{unit}"],
                                         _node(s, dec, f"BatchNorm_{unit}"),
                                         f"{dec}/BatchNorm_{unit}")
        layers.append((bn, bn_train + bn_stats))


def _numbered(tree: Mapping, prefix: str) -> List[str]:
    return sorted((k for k in tree if k.startswith(prefix)),
                  key=lambda k: int(k.rsplit("_", 1)[1]))


def _unet_trunk_layers(names: _Names, params, stats,
                       enc_prefix: str) -> Tuple[Layers, List[str]]:
    """The encoder blocks and the center conv_block (when the tree has one)
    of a U-Net trunk as Keras layers, and the names of its decoder levels.
    The center's layer name starts with conv_block (that is how
    keras_import tells it from the encoders): the next free one."""
    enc_names = _numbered(params, enc_prefix)
    dec_names = _numbered(params, "DecoderBlock_")
    if len(enc_names) != len(dec_names):
        raise ValueError(f"{len(enc_names)} encoder vs {len(dec_names)} decoder blocks")
    layers: Layers = []
    for enc in enc_names:
        lname = names.next("encoder_block")
        layers.append((lname, _cba_block_weights(lname, names, params[enc]["ConvBlock_0"],
                                                 stats.get(enc, {}).get("ConvBlock_0", {}))))
    if "ConvBlock_0" in params:
        center = names.next("conv_block")
        layers.append((center, _cba_block_weights(center, names, params["ConvBlock_0"],
                                                  stats.get("ConvBlock_0", {}))))
    return layers, dec_names


def _decoder_layers(layers: Layers, names: _Names, dec_names, params, stats) -> None:
    for dec in dec_names:
        _append_decoder_layers(layers, names, dec, params[dec], stats.get(dec, {}))


def keras_unet_layers(model: torch.nn.Module) -> Layers:
    """A ``models.UNet``'s weights as the reference's Keras layers
    (utils/model_tools.py:321-531): encoder blocks, the center conv_block,
    functional decoder levels and the ``logits`` head (any
    ``convs_per_block``, any head: the head is architecture, not weights).
    Raises ``ValueError`` for what the reference architecture cannot hold:
    the space-to-depth stem and folded BatchNorm."""
    params, stats = torch_to_flax(model)
    if "stem_upsample" in params:
        raise ValueError(
            "space_to_depth UNets are an architectural variant with no "
            "reference-Keras equivalent — train with space_to_depth=False "
            "to produce exportable weights"
        )
    if not _numbered(params, "EncoderBlock_") or "ConvBlock_0" not in params \
            or "head" not in params:
        raise ValueError("not a UNet variable tree (need EncoderBlock_*, ConvBlock_0, head)")
    names = _Names()
    layers, dec_names = _unet_trunk_layers(names, params, stats, "EncoderBlock_")
    _decoder_layers(layers, names, dec_names, params, stats)
    layers.append(("logits", _conv_weights("logits", params["head"])))
    return layers


def keras_siamese_layers(model: torch.nn.Module) -> Layers:
    """A ``models.SiameseUNet``'s weights as the reference's Keras layers
    (get_siamese_layers / make_siamese_unet, utils/model_tools.py:576-663):
    shared ``encoder_block`` groups, the shared ``ASPP`` Layer, flat
    decoder levels and the sigmoid ``probs`` head. The ASPP's weights
    follow Keras sublayer creation order — 1x1, fuse 1x1 (``cba3``; its
    twin ``cba2`` is never called), then the dilated 3x3s — where the
    port's ``blocks.ASPP`` orders them 1x1, d3, d6, d12, fuse.

    An encoder block of four or more convs is refused: the importer takes
    the first group of four or more convs for the ASPP."""
    params, stats = torch_to_flax(model)
    if not _numbered(params, "encoder_") or "aspp" not in params or "head" not in params:
        raise ValueError("not a SiameseUNet variable tree (need encoder_*, aspp, head)")
    for enc in _numbered(params, "encoder_"):
        n_cba = len([k for k in params[enc]["ConvBlock_0"] if k.startswith("ConvBNAct_")])
        if n_cba >= 4:
            raise ValueError(
                f"{enc}: {n_cba} convs per block — keras_import reads a group of four "
                "or more convs as the ASPP, so the file would not load back; export a "
                "SiameseUNet with convs_per_block <= 3 (the reference's has 1)"
            )
    names = _Names()
    layers, dec_names = _unet_trunk_layers(names, params, stats, "encoder_")

    aspp_p, aspp_s = params["aspp"], stats.get("aspp", {})
    n_cba = len([k for k in aspp_p if k.startswith("ConvBNAct_")])
    if n_cba != 5:
        raise ValueError(f"aspp: expected 5 ConvBNAct_* subtrees, got {n_cba}")
    trainable: Weights = []
    non_trainable: Weights = []
    for idx in (0, 4, 1, 2, 3):  # port order -> the reference's creation order
        where = f"aspp/ConvBNAct_{idx}"
        sub_p = aspp_p[f"ConvBNAct_{idx}"]
        if "BatchNorm_0" not in sub_p:
            raise ValueError(f"{where}: {_NOT_EXPORTABLE}")
        cba = names.next("conv_batch_act")
        conv = names.next("conv2d")
        bn = names.next("batch_normalization")
        pfx = f"ASPP/{cba}"
        trainable.extend(_conv_weights(f"{pfx}/{conv}", sub_p["Conv_0"]))
        bn_train, bn_stats = _bn_weights(
            f"{pfx}/{bn}", sub_p["BatchNorm_0"],
            _node(aspp_s, where, f"ConvBNAct_{idx}", "BatchNorm_0"), where)
        trainable.extend(bn_train)
        non_trainable.extend(bn_stats)
    layers.append(("ASPP", trainable + non_trainable))

    _decoder_layers(layers, names, dec_names, params, stats)
    layers.append(("probs", _conv_weights("probs", params["head"])))
    return layers


def _convlstm_weights(parent: str, p_tree) -> Weights:
    """The cell's input/recurrent conv pair as one Keras ConvLSTM2D unit,
    the forget quarter of the bias shifted up by the unit forget bias."""
    cell = p_tree["cell"]
    rk = _np(cell["recurrent_conv"]["kernel"])
    feats = rk.shape[2]
    bias = _np(cell["input_conv"]["bias"]).copy()
    bias[feats: 2 * feats] += 1.0
    return [
        (f"{parent}/kernel:0", _np(cell["input_conv"]["kernel"])),
        (f"{parent}/recurrent_kernel:0", rk),
        (f"{parent}/bias:0", bias),
    ]


def _lstm_stack_layers(p, s, where: str) -> Layers:
    """build_lstm_layers / build_lstm_layers2 as the reference's four named
    layers (utils/model_tools.py:666-771): conv_lstm, batch_norm,
    dilated_conv_lstm, batch_norm2."""
    layers: Layers = []
    for i, (lstm_name, bn_name) in enumerate(
            (("conv_lstm", "batch_norm"), ("dilated_conv_lstm", "batch_norm2"))):
        if f"ConvLSTM_{i}" not in p or f"BatchNorm_{i}" not in p:
            raise ValueError(f"not an LSTM stack tree (need ConvLSTM_{i}/BatchNorm_{i})")
        layers.append((lstm_name, _convlstm_weights(lstm_name, p[f"ConvLSTM_{i}"])))
        bn_train, bn_stats = _bn_weights(bn_name, p[f"BatchNorm_{i}"],
                                         _node(s, where, f"BatchNorm_{i}"),
                                         f"{where}/BatchNorm_{i}")
        layers.append((bn_name, bn_train + bn_stats))
    return layers


def keras_lstm_layers(model: torch.nn.Module) -> Layers:
    """A ``models.LSTMModel``'s weights as the reference's Keras layers
    (get_lstm_model, utils/model_tools.py:773-808): the named ConvLSTM
    stack, then the 1x1 head conv under the capped ReLU."""
    params, stats = torch_to_flax(model)
    if "LSTMStack_0" not in params or "Conv_0" not in params:
        raise ValueError("not an LSTMModel variable tree (need LSTMStack_0, Conv_0)")
    layers = _lstm_stack_layers(params["LSTMStack_0"], stats.get("LSTMStack_0", {}),
                                "LSTMStack_0")
    layers.append(("conv2d", _conv_weights("conv2d", params["Conv_0"])))
    return layers


def keras_lstm_autoencoder_layers(model: torch.nn.Module) -> Layers:
    """A ``models.LSTMAutoencoder``'s weights as the reference's Keras
    layers (get_lstm_autoencoder, utils/model_tools.py:810-872): the
    residual encoder stack, the repeated-state ``lstm_decoder``, the
    TimeDistributed ``temporal_dense`` head (its weights under the wrapper
    layer with the inner conv's paths) and the ``single_dense`` next-step
    head."""
    params, stats = torch_to_flax(model)
    missing = {"LSTMStack2_0", "lstm_decoder", "temporal_dense", "single_dense"} - set(params)
    if missing:
        raise ValueError(f"not an LSTMAutoencoder variable tree (missing {sorted(missing)})")
    layers = _lstm_stack_layers(params["LSTMStack2_0"], stats.get("LSTMStack2_0", {}),
                                "LSTMStack2_0")
    layers.append(("lstm_decoder", _convlstm_weights("lstm_decoder", params["lstm_decoder"])))
    layers.append(("time_distributed",
                   _conv_weights("temporal_dense", params["temporal_dense"])))
    layers.append(("single_dense", _conv_weights("single_dense", params["single_dense"])))
    return layers


def keras_hybrid_layers(model: torch.nn.Module) -> Layers:
    """A ``models.HybridUNetLSTM``'s weights as the reference's Keras
    layers (get_hybrid_model, utils/model_tools.py:874-920): the U-Net
    trunk, the 1x1 ``unet_dense``, the four named LSTM-stack layers, the
    1x1 ``lstm_dense`` and the fusing ``probabilities`` head. The unet
    dense conv is numbered before the lstm dense (Keras' global auto-name
    counter follows the builder's creation order), which is what the
    importer falls back on when both read equal widths."""
    params, stats = torch_to_flax(model)
    missing = {"unet", "LSTMStack_0", "unet_dense", "lstm_dense", "probabilities"} \
        - set(params)
    if missing:
        raise ValueError(f"not a HybridUNetLSTM variable tree (missing {sorted(missing)})")
    unet_p, unet_s = params["unet"], stats.get("unet", {})
    if not _numbered(unet_p, "EncoderBlock_") or "ConvBlock_0" not in unet_p:
        raise ValueError("hybrid unet trunk: need EncoderBlock_*, ConvBlock_0")
    names = _Names()
    layers, dec_names = _unet_trunk_layers(names, unet_p, unet_s, "EncoderBlock_")
    _decoder_layers(layers, names, dec_names, unet_p, unet_s)
    unet_dense = names.next("conv2d")
    layers.append((unet_dense, _conv_weights(unet_dense, params["unet_dense"])))
    layers.extend(_lstm_stack_layers(params["LSTMStack_0"], stats.get("LSTMStack_0", {}),
                                     "LSTMStack_0"))
    lstm_dense = names.next("conv2d")
    layers.append((lstm_dense, _conv_weights(lstm_dense, params["lstm_dense"])))
    layers.append(("probabilities", _conv_weights("probabilities", params["probabilities"])))
    return layers


def _write_h5(layers: Layers, path_or_buf) -> None:
    import h5py

    with h5py.File(path_or_buf, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n, _ in layers])
        # Keras' legacy loader keys conversion behavior off these; 2.x +
        # tensorflow is the no-conversion path
        f.attrs["keras_version"] = np.bytes_(b"2.15.0")
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        for lname, weights in layers:
            g = f.create_group(lname)
            g.attrs["weight_names"] = np.array([w.encode() for w, _ in weights])
            for wname, arr in weights:
                g.create_dataset(wname, data=arr)


def _bytes(layers: Layers) -> bytes:
    buf = io.BytesIO()
    _write_h5(layers, buf)
    return buf.getvalue()


def export_keras_unet_h5(model: torch.nn.Module, path_or_buf) -> None:
    """Write a ``models.UNet`` as a reference-layout Keras ``.h5`` weights
    file (:func:`keras_unet_layers`)."""
    _write_h5(keras_unet_layers(model), path_or_buf)


def export_keras_unet_h5_bytes(model: torch.nn.Module) -> bytes:
    """The U-Net ``.h5`` file as bytes (e.g. for a blob upload through
    ``cloud.blob``, the reference's model-artifact channel)."""
    return _bytes(keras_unet_layers(model))


def export_keras_siamese_h5(model: torch.nn.Module, path_or_buf) -> None:
    """Write a ``models.SiameseUNet`` as a reference-layout Keras ``.h5``
    (:func:`keras_siamese_layers`)."""
    _write_h5(keras_siamese_layers(model), path_or_buf)


def export_keras_siamese_h5_bytes(model: torch.nn.Module) -> bytes:
    """The Siamese U-Net ``.h5`` file as bytes."""
    return _bytes(keras_siamese_layers(model))


def export_keras_lstm_h5(model: torch.nn.Module, path_or_buf) -> None:
    """Write a ``models.LSTMModel`` as a reference-layout Keras ``.h5``
    (:func:`keras_lstm_layers`)."""
    _write_h5(keras_lstm_layers(model), path_or_buf)


def export_keras_lstm_autoencoder_h5(model: torch.nn.Module, path_or_buf) -> None:
    """Write a ``models.LSTMAutoencoder`` as a reference-layout Keras
    ``.h5`` (:func:`keras_lstm_autoencoder_layers`)."""
    _write_h5(keras_lstm_autoencoder_layers(model), path_or_buf)


def export_keras_hybrid_h5(model: torch.nn.Module, path_or_buf) -> None:
    """Write a ``models.HybridUNetLSTM`` as a reference-layout Keras
    ``.h5`` (:func:`keras_hybrid_layers`)."""
    _write_h5(keras_hybrid_layers(model), path_or_buf)
