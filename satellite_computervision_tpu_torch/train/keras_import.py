"""Import the reference's published Keras ``.h5``/``.hdf5`` weights.

Port of ``satellite_computervision_tpu/train/keras_import.py``. The
reference's deliverable models are Keras HDF5 blobs saved by
``model.save`` / ``ModelCheckpoint`` (utils/model_tools.py:1128-1269). This
module reads that format (h5py, imported when a file is read; no
TensorFlow) and maps the five importable families onto the port's models.

Each loader maps the file onto the model's weights in the flax layout
(``models.bridge.torch_to_flax``), exactly as the JAX loader maps it onto
a flax tree, and loads the result back with ``flax_to_torch``. So the
tensor conventions are the JAX package's:

- Conv2D kernels are stored HWIO, flax's order;
- Conv2DTranspose kernels are stored (kh, kw, out, in) and Keras computes
  the gradient of a conv: the flax kernel is the stored one flipped in
  space and transposed to (kh, kw, in, out) (``flax_to_torch`` then flips
  it again for ``ConvTranspose2d``);
- BatchNorm gamma/beta -> scale/bias, moving_mean/moving_variance ->
  mean/var. Keras epsilon 1e-3 is ``models.blocks.BN_EPS``;
- a ConvLSTM2D keeps Keras's unit forget bias inside its stored bias;
  the port's cell adds the 1 at run time (``models/convlstm.py``), so the
  forget quarter is shifted down by 1 on import.

Architecture note: the reference's ``conv_block.call`` invokes its first
conv_batch_act twice and never the second (utils/model_tools.py:238-239),
so saved files contain ONE conv+BN per encoder/center block. Build the
target with ``convs_per_block=1`` to receive them; the loader checks that
the unit counts line up and says so if not.

A loader takes a path, a URL, the file's bytes, a file object, or the
file's layers already in memory (the list :func:`keras_layers` returns
and the exporters' ``keras_*_layers`` build), and a model of the port
(one built on the meta device by ``train.checkpoint.build_empty`` too);
it returns the model with the weights loaded, in eval mode.
"""

from __future__ import annotations

import io
import re
import urllib.request
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch.models.bridge import flax_to_torch, torch_to_flax

__all__ = [
    "keras_layers",
    "read_keras_h5_units",
    "infer_unet_arch",
    "load_keras_unet_h5",
    "load_keras_siamese_h5",
    "load_keras_lstm_h5",
    "load_keras_lstm_autoencoder_h5",
    "load_keras_hybrid_h5",
]

Layers = List[Tuple[str, List[Tuple[str, np.ndarray]]]]


def _decode(name) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


def keras_layers(source) -> Layers:
    """``(layer_name, [(weight_path, array), ...])`` in Keras creation
    order, for both full-model files (``model_weights`` group) and
    ``save_weights`` files (layers at the root). ``source`` is a path, a
    URL (``https://``, ``file://``), the file's bytes or a file object; a
    list is taken as the layers already."""
    if isinstance(source, list):
        return source
    if isinstance(source, str) and "://" in source:
        with urllib.request.urlopen(source) as resp:
            source = resp.read()
    import h5py

    src = io.BytesIO(source) if isinstance(source, bytes) else source
    with h5py.File(src, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        if "layer_names" not in g.attrs:
            raise ValueError("not a Keras HDF5 weights file (no layer_names attr)")
        out = []
        for lname in g.attrs["layer_names"]:
            lname = _decode(lname)
            grp = g[lname]
            wnames = [_decode(n) for n in grp.attrs.get("weight_names", [])]
            out.append((lname, [(n, np.asarray(grp[n])) for n in wnames]))
    return out


class _Unit:
    """One parameterized layer: conv / conv_transpose / batch norm /
    convlstm."""

    def __init__(self, path: str):
        self.path = path
        self.tensors: Dict[str, np.ndarray] = {}

    @property
    def kind(self) -> str:
        if "gamma" in self.tensors:
            return "bn"
        if "recurrent_kernel" in self.tensors:
            return "convlstm"
        if self.tensors.get("kernel") is None:
            return "other"
        if "transpose" in self.path.rsplit("/", 1)[-1]:
            return "conv_transpose"
        return "conv"


def read_keras_h5_units(source):
    """Parse a Keras HDF5 file into ordered ``(layer_name, [units])``, each
    unit one conv / conv-transpose / BN / ConvLSTM with its tensors by
    basename."""
    result = []
    for lname, weights in keras_layers(source):
        units: List[_Unit] = []
        by_parent: Dict[str, _Unit] = {}
        for wpath, arr in weights:
            parent, _, base = wpath.rpartition("/")
            base = base.split(":")[0]
            if parent not in by_parent:
                by_parent[parent] = _Unit(parent)
                units.append(by_parent[parent])
            by_parent[parent].tensors[base] = arr
        result.append((lname, units))
    return result


def infer_unet_arch(source) -> Dict[str, object]:
    """The ``models.UNet`` constructor arguments of a reference U-Net
    ``.h5`` — bands, per-level filters, convs_per_block and n_classes —
    from the stored kernel shapes, so the published-weights workflow
    (``evaluate --h5``) needs no hand-supplied architecture."""
    enc_convs: List[List[np.ndarray]] = []
    head_kernel = None
    for lname, units in read_keras_h5_units(source):
        if not units:
            continue
        if any("conv_batch_act" in u.path for u in units) \
                and not lname.startswith("conv_block"):
            enc_convs.append([u.tensors["kernel"] for u in units if u.kind == "conv"])
        elif units[-1].kind == "conv":
            head_kernel = units[-1].tensors["kernel"]
    if not enc_convs:
        raise ValueError("no encoder blocks found — not a reference U-Net h5")
    if head_kernel is None:
        raise ValueError("no trailing head conv found")
    filters = tuple(int(ks[-1].shape[-1]) for ks in enc_convs)
    return {
        "bands": int(enc_convs[0][0].shape[2]),
        "filters": filters,
        "factors": (2,) * len(filters),
        "convs_per_block": len(enc_convs[0]),
        "n_classes": int(head_kernel.shape[-1]),
    }


def _conv_params(u: _Unit) -> Dict[str, np.ndarray]:
    p = {"kernel": u.tensors["kernel"]}
    if "bias" in u.tensors:
        p["bias"] = u.tensors["bias"]
    return p


def _conv_transpose_params(u: _Unit) -> Dict[str, np.ndarray]:
    k = u.tensors["kernel"]  # (kh, kw, out, in)
    p = {"kernel": k[::-1, ::-1].transpose(0, 1, 3, 2).copy()}
    if "bias" in u.tensors:
        p["bias"] = u.tensors["bias"]
    return p


def _bn_params(u: _Unit):
    params = {"scale": u.tensors["gamma"], "bias": u.tensors["beta"]}
    stats = {"mean": u.tensors["moving_mean"], "var": u.tensors["moving_variance"]}
    return params, stats


def _require_shape(dst, src, where: str):
    if tuple(np.shape(dst)) != tuple(np.shape(src)):
        raise ValueError(
            f"{where}: kernel shape mismatch {np.shape(src)} (h5) vs "
            f"{np.shape(dst)} (model) — filters/factors/bands/time-steps differ"
        )


def _load(model: torch.nn.Module, params, batch_stats) -> torch.nn.Module:
    """Put a flax-layout tree into ``model``: assigned (float32, CPU) into
    a meta-device model, copied into the model's own tensors otherwise."""
    meta = any(t.is_meta for t in model.state_dict().values())
    model.load_state_dict(flax_to_torch(params, batch_stats, model), assign=meta)
    return model.eval()


def _assign_cba_seq(units: List[_Unit], p_tree, s_tree, where: str, model: str):
    """conv/BN unit pairs -> the ConvBNAct_i subtrees of a ConvBlock."""
    convs = [u for u in units if u.kind == "conv"]
    bns = [u for u in units if u.kind == "bn"]
    want = len([k for k in p_tree if k.startswith("ConvBNAct_")])
    if len(convs) != want or len(bns) != want:
        raise ValueError(
            f"{where}: h5 has {len(convs)} conv(s) per block but the model "
            f"expects {want} — build {model}(convs_per_block={len(convs)}) "
            "(the reference's shipped architecture has 1: conv_block "
            "double-call, utils/model_tools.py:238-239)"
        )
    for i, (cu, bu) in enumerate(zip(convs, bns)):
        sub = p_tree[f"ConvBNAct_{i}"]
        _require_shape(sub["Conv_0"]["kernel"], cu.tensors["kernel"], where)
        sub["Conv_0"].update(_conv_params(cu))
        bp, bs = _bn_params(bu)
        sub["BatchNorm_0"].update(bp)
        s_tree[f"ConvBNAct_{i}"]["BatchNorm_0"].update(bs)


def _assign_decoder_level(p, s, units, name: str):
    """[convT, bn, conv, bn, conv, bn] -> a DecoderBlock subtree (the
    functional decoder_block, utils/model_tools.py:266-319)."""
    kinds = [u.kind for u in units]
    if kinds != ["conv_transpose", "bn", "conv", "bn", "conv", "bn"]:
        raise ValueError(f"{name}: unexpected decoder unit sequence {kinds}")
    _require_shape(
        p["ConvTranspose_0"]["kernel"],
        units[0].tensors["kernel"].transpose(0, 1, 3, 2),
        name,
    )
    p["ConvTranspose_0"].update(_conv_transpose_params(units[0]))
    for bn_idx, unit in ((0, units[1]), (1, units[3]), (2, units[5])):
        bp, bs = _bn_params(unit)
        p[f"BatchNorm_{bn_idx}"].update(bp)
        s[f"BatchNorm_{bn_idx}"].update(bs)
    for conv_idx, unit in ((0, units[2]), (1, units[4])):
        _require_shape(p[f"Conv_{conv_idx}"]["kernel"], unit.tensors["kernel"], name)
        p[f"Conv_{conv_idx}"].update(_conv_params(unit))


def _split_decoders(flat: List[_Unit], n_encoders: int) -> List[List[_Unit]]:
    """Flat decoder units -> one list per level, split at each
    conv_transpose."""
    decoders: List[List[_Unit]] = []
    for u in flat:
        if u.kind == "conv_transpose":
            decoders.append([u])
        else:
            if not decoders:
                raise ValueError("decoder units precede the first conv_transpose")
            decoders[-1].append(u)
    if len(decoders) != n_encoders:
        raise ValueError(
            f"{n_encoders} encoder blocks but {len(decoders)} decoder levels"
        )
    return decoders


def _assign_convlstm(p_tree, u: _Unit, where: str):
    """Keras ConvLSTM2D unit -> the ConvLSTM's ``cell`` subtree: kernel
    (kh, kw, Cin, 4F) -> ``input_conv``, recurrent_kernel (kh, kw, F, 4F)
    -> ``recurrent_conv``, bias (4F,) with the forget quarter shifted down
    by the unit forget bias the cell adds at run time; gate order i, f, c,
    o in both."""
    cell = p_tree["cell"]
    feats = u.tensors["recurrent_kernel"].shape[2]
    bias = np.asarray(u.tensors["bias"], np.float32).copy()
    bias[feats: 2 * feats] -= 1.0
    _require_shape(cell["input_conv"]["kernel"], u.tensors["kernel"], where)
    _require_shape(cell["recurrent_conv"]["kernel"], u.tensors["recurrent_kernel"], where)
    cell["input_conv"]["kernel"] = np.asarray(u.tensors["kernel"])
    cell["input_conv"]["bias"] = bias
    cell["recurrent_conv"]["kernel"] = np.asarray(u.tensors["recurrent_kernel"])


def _assign_lstm_stack(p_tree, s_tree, units, where: str):
    """[convlstm, bn, convlstm, bn] -> LSTMStack/LSTMStack2 subtrees
    (build_lstm_layers / build_lstm_layers2, utils/model_tools.py:666-771)."""
    kinds = [u.kind for u in units]
    if kinds != ["convlstm", "bn", "convlstm", "bn"]:
        raise ValueError(f"{where}: unexpected LSTM stack unit sequence {kinds}")
    for i, (lstm_u, bn_u) in enumerate([(units[0], units[1]), (units[2], units[3])]):
        _assign_convlstm(p_tree[f"ConvLSTM_{i}"], lstm_u, f"{where}.ConvLSTM_{i}")
        bp, bs = _bn_params(bn_u)
        p_tree[f"BatchNorm_{i}"].update(bp)
        s_tree[f"BatchNorm_{i}"].update(bs)


def _unet_groups(layers, named: Tuple[str, ...] = ()):
    """Encoder unit groups, the center group and the remaining flat units
    of a U-Net trunk; layers named in ``named`` are returned apart."""
    encoders: List[List[_Unit]] = []
    center: Optional[List[_Unit]] = None
    flat: List[_Unit] = []
    apart: Dict[str, List[_Unit]] = {}
    for lname, units in layers:
        if not units:
            continue
        if lname in named:
            apart[lname] = units
            continue
        nested = any("conv_batch_act" in u.path for u in units)
        if nested and center is None and not lname.startswith("conv_block"):
            encoders.append(units)
        elif nested or lname.startswith("conv_block"):
            if center is not None:
                raise ValueError(f"second center conv_block {lname!r}")
            center = units
        else:
            flat.extend(units)
    return encoders, center, flat, apart


def load_keras_unet_h5(source, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference U-Net ``.h5`` into a ``models.UNet``.

    Expects the binary/multiclass/autoencoder U-Net families built by
    utils/model_tools.py:321-531: encoder blocks (Keras Layer subclasses,
    each one effective conv+BN — or two if a fixed fork saved them), a
    center conv_block, functional decoder_blocks (convT + BN + 2x(conv+BN)),
    and a 1x1 head conv."""
    encoders, center, flat, _ = _unet_groups(read_keras_h5_units(source))
    if center is None:
        raise ValueError("no center conv_block found in the h5 file")
    if not flat or flat[0].kind != "conv_transpose":
        raise ValueError("no decoder conv_transpose units found")
    head_unit = flat[-1]
    if head_unit.kind != "conv":
        raise ValueError(f"expected trailing head conv, got {head_unit.kind}")
    decoders = _split_decoders(flat[:-1], len(encoders))

    params, batch_stats = torch_to_flax(model)
    for i, units in enumerate(encoders):
        name = f"EncoderBlock_{i}"
        _assign_cba_seq(units, params[name]["ConvBlock_0"], batch_stats[name]["ConvBlock_0"],
                        name, "UNet")
    _assign_cba_seq(center, params["ConvBlock_0"], batch_stats["ConvBlock_0"], "center",
                    "UNet")
    for i, units in enumerate(decoders):
        name = f"DecoderBlock_{i}"
        _assign_decoder_level(params[name], batch_stats[name], units, name)
    _require_shape(params["head"]["kernel"], head_unit.tensors["kernel"], "head")
    params["head"].update(_conv_params(head_unit))
    return _load(model, params, batch_stats)


def load_keras_siamese_h5(source, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference Siamese U-Net ``.h5`` into a ``models.SiameseUNet``.

    Reference builder: get_siamese_layers / make_siamese_unet
    (utils/model_tools.py:576-663) — weight-shared encoder_block Layers,
    one shared DilatedSpatialPyramidPooling, functional decoder_blocks and
    a sigmoid 'probs' head. The ASPP Layer tracks its sublayers in
    creation order (cba 1x1, [cba2 unbuilt], cba3 fuse-1x1, then the
    dilated 3x3s), so its units are assigned by kernel shape: the 1x1
    whose input width is 4x features is the fuse conv; the 3x3s keep their
    creation order (dilations 3, 6, 12 — dilation is not a weight). The
    group of four or more convs is taken as the ASPP, as the JAX loader
    takes it; the port's exporter refuses encoder blocks of four or more
    convs for that reason."""
    encoders: List[List[_Unit]] = []
    aspp: Optional[List[_Unit]] = None
    flat: List[_Unit] = []
    for lname, units in read_keras_h5_units(source):
        if not units:
            continue
        nested = any("conv_batch_act" in u.path for u in units)
        n_convs = sum(1 for u in units if u.kind == "conv")
        if nested and n_convs >= 4:
            if aspp is not None:
                raise ValueError(f"second ASPP-like group {lname!r}")
            aspp = units
        elif nested:
            encoders.append(units)
        else:
            flat.extend(units)
    if aspp is None:
        raise ValueError("no ASPP group found (not a siamese .h5?)")
    if not flat or flat[-1].kind != "conv":
        raise ValueError("expected trailing head conv")
    head_unit = flat[-1]
    decoders = _split_decoders(flat[:-1], len(encoders))

    params, batch_stats = torch_to_flax(model)
    for i, units in enumerate(encoders):
        name = f"encoder_{i}"
        _assign_cba_seq(units, params[name]["ConvBlock_0"], batch_stats[name]["ConvBlock_0"],
                        name, "SiameseUNet")

    # ASPP: units by shape — blocks.ASPP order is 1x1, d3, d6, d12, fuse
    convs = [u for u in aspp if u.kind == "conv"]
    bns = [u for u in aspp if u.kind == "bn"]
    if len(convs) != 5:
        raise ValueError(f"ASPP: expected 5 conv units, got {len(convs)}")
    features = convs[0].tensors["kernel"].shape[-1]
    ones = [(c, b) for c, b in zip(convs, bns) if c.tensors["kernel"].shape[:2] == (1, 1)]
    threes = [(c, b) for c, b in zip(convs, bns) if c.tensors["kernel"].shape[:2] == (3, 3)]
    if len(ones) != 2 or len(threes) != 3:
        raise ValueError("ASPP: expected two 1x1 and three 3x3 conv units")
    fuse = max(ones, key=lambda cb: cb[0].tensors["kernel"].shape[2])
    first = ones[0] if ones[1] is fuse else ones[1]
    if fuse[0].tensors["kernel"].shape[2] != 4 * features:
        raise ValueError("ASPP: could not identify the fuse conv by input width")
    for ci, (cu, bu) in enumerate([first, *threes, fuse]):
        _assign_cba_seq([cu, bu], {"ConvBNAct_0": params["aspp"][f"ConvBNAct_{ci}"]},
                        {"ConvBNAct_0": batch_stats["aspp"][f"ConvBNAct_{ci}"]},
                        f"aspp[{ci}]", "SiameseUNet")

    for i, units in enumerate(decoders):
        name = f"DecoderBlock_{i}"
        _assign_decoder_level(params[name], batch_stats[name], units, name)
    _require_shape(params["head"]["kernel"], head_unit.tensors["kernel"], "head")
    params["head"].update(_conv_params(head_unit))
    return _load(model, params, batch_stats)


def _lstm_units(source, want: List[str], builder: str) -> List[_Unit]:
    units = [u for _, us in read_keras_h5_units(source) for u in us if u.kind != "other"]
    kinds = [u.kind for u in units]
    if kinds != want:
        raise ValueError(
            f"not a {builder} .h5: unit sequence {kinds} (expected {', '.join(want)})"
        )
    return units


def load_keras_lstm_h5(source, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference LSTM regression ``.h5`` into a ``models.LSTMModel``.

    Reference builder get_lstm_model (utils/model_tools.py:773-808):
    build_lstm_layers — ConvLSTM2D(64) 'conv_lstm', BN 'batch_norm',
    dilated ConvLSTM2D(64) 'dilated_conv_lstm', BN 'batch_norm2' — then a
    1x1 Conv2D head under the capped ReLU."""
    units = _lstm_units(source, ["convlstm", "bn", "convlstm", "bn", "conv"],
                        "get_lstm_model")
    params, batch_stats = torch_to_flax(model)
    _assign_lstm_stack(params["LSTMStack_0"], batch_stats["LSTMStack_0"], units[:4],
                       "LSTMStack_0")
    _require_shape(params["Conv_0"]["kernel"], units[4].tensors["kernel"], "head")
    params["Conv_0"].update(_conv_params(units[4]))
    return _load(model, params, batch_stats)


def load_keras_lstm_autoencoder_h5(source, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference LSTM autoencoder ``.h5`` into a
    ``models.LSTMAutoencoder``.

    Reference builder get_lstm_autoencoder (utils/model_tools.py:810-872):
    build_lstm_layers2 encoder (ConvLSTM2D(16) + BN, dilated ConvLSTM2D(16)
    + BN, residual state_h add), ConvLSTM2D(32) 'lstm_decoder',
    TimeDistributed 1x1 'temporal_dense', and 1x1 'single_dense' over
    encoded+sincos. The two head convs are matched by their layer names
    when present, creation order otherwise."""
    units = _lstm_units(source, ["convlstm", "bn", "convlstm", "bn", "convlstm", "conv", "conv"],
                        "get_lstm_autoencoder")
    params, batch_stats = torch_to_flax(model)
    _assign_lstm_stack(params["LSTMStack2_0"], batch_stats["LSTMStack2_0"], units[:4],
                       "LSTMStack2_0")
    _assign_convlstm(params["lstm_decoder"], units[4], "lstm_decoder")
    temporal, single = units[5], units[6]
    if "single" in temporal.path and "single" not in single.path:
        temporal, single = single, temporal
    for tgt, unit in (("temporal_dense", temporal), ("single_dense", single)):
        _require_shape(params[tgt]["kernel"], unit.tensors["kernel"], tgt)
        params[tgt].update(_conv_params(unit))
    return _load(model, params, batch_stats)


def load_keras_hybrid_h5(source, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference hybrid U-Net/LSTM ``.h5`` into a
    ``models.HybridUNetLSTM``.

    Reference builder get_hybrid_model (utils/model_tools.py:874-920):
    a build_unet_layers trunk (encoder_block Layers, center conv_block,
    functional decoder levels) + 1x1 'unet_dense' ReLU conv, the named
    build_lstm_layers stack ('conv_lstm'/'batch_norm'/
    'dilated_conv_lstm'/'batch_norm2') + 1x1 lstm dense conv, and the
    fusing 1x1 softmax conv named 'probabilities'. The h5's layer order is
    a topological sort that interleaves the two branches, so the dense 1x1
    convs are found by shape (the only 1x1 convs giving n_classes), the
    LSTM stack by its layer names, and the rest are decoder levels of six
    units each."""
    lstm_names = ("conv_lstm", "batch_norm", "dilated_conv_lstm", "batch_norm2")
    encoders, center, flat, apart = _unet_groups(read_keras_h5_units(source),
                                                 lstm_names + ("probabilities",))
    for lname in lstm_names:
        if lname in apart and len(apart[lname]) != 1:
            raise ValueError(f"{lname}: expected one unit, got {len(apart[lname])}")
    missing = set(lstm_names) - set(apart)
    if missing:
        raise ValueError(f"not a get_hybrid_model .h5: missing layers {sorted(missing)}")
    if center is None or "probabilities" not in apart:
        raise ValueError("not a get_hybrid_model .h5: no center conv_block / "
                         "'probabilities' head")
    prob_unit = apart["probabilities"][0]

    prob_out = prob_unit.tensors["kernel"].shape[-1]
    dense_units = [
        u for u in flat
        if u.kind == "conv"
        and tuple(u.tensors["kernel"].shape[:2]) == (1, 1)
        and u.tensors["kernel"].shape[-1] == prob_out
    ]
    if len(dense_units) != 2:
        raise ValueError(
            f"expected 2 dense 1x1 convs (unet/lstm), found {len(dense_units)}"
        )
    flat = [u for u in flat if u not in dense_units]
    decoders: List[List[_Unit]] = []
    i = 0
    while i < len(flat) and flat[i].kind == "conv_transpose":
        decoders.append(flat[i: i + 6])
        i += 6
    if i != len(flat):
        raise ValueError(
            f"unrecognized trailing units after decoder levels: "
            f"{[u.kind for u in flat[i:]]}"
        )
    if len(decoders) != len(encoders):
        raise ValueError(
            f"{len(encoders)} encoder blocks but {len(decoders)} decoder levels"
        )

    params, batch_stats = torch_to_flax(model)
    unet_p, unet_s = params["unet"], batch_stats["unet"]

    # unet_dense reads the last decoder's f0 channels; lstm_dense the LSTM
    # stack's features. When those widths coincide, fall back to creation
    # order (Keras' global auto-name counter: the unet dense is created
    # before the whole LSTM branch in get_hybrid_model).
    def creation_index(u: _Unit) -> int:
        m = re.search(r"(\d+)$", u.path.split("/")[0])
        return int(m.group(1)) if m else -1

    want_unet_in = np.shape(params["unet_dense"]["kernel"])[2]
    want_lstm_in = np.shape(params["lstm_dense"]["kernel"])[2]
    a, b = dense_units
    a_in, b_in = a.tensors["kernel"].shape[2], b.tensors["kernel"].shape[2]
    if want_unet_in != want_lstm_in and {a_in, b_in} == {want_unet_in, want_lstm_in}:
        unet_dense_u = a if a_in == want_unet_in else b
        lstm_dense_u = b if unet_dense_u is a else a
    else:
        unet_dense_u, lstm_dense_u = sorted(dense_units, key=creation_index)

    for ei, units in enumerate(encoders):
        name = f"EncoderBlock_{ei}"
        _assign_cba_seq(units, unet_p[name]["ConvBlock_0"], unet_s[name]["ConvBlock_0"], name,
                        "HybridUNetLSTM")
    _assign_cba_seq(center, unet_p["ConvBlock_0"], unet_s["ConvBlock_0"], "center",
                    "HybridUNetLSTM")
    for di, units in enumerate(decoders):
        name = f"DecoderBlock_{di}"
        _assign_decoder_level(unet_p[name], unet_s[name], units, name)
    _assign_lstm_stack(params["LSTMStack_0"], batch_stats["LSTMStack_0"],
                       [apart[n][0] for n in lstm_names], "LSTMStack_0")
    for tgt, unit in (("unet_dense", unet_dense_u), ("lstm_dense", lstm_dense_u),
                      ("probabilities", prob_unit)):
        _require_shape(params[tgt]["kernel"], unit.tensors["kernel"], tgt)
        params[tgt].update(_conv_params(unit))
    return _load(model, params, batch_stats)
