"""Reference-API compatibility layer.

Port of ``satellite_computervision_tpu/compat.py``: the public names of
mjevans26/Satellite_ComputerVision's ``utils`` modules, each mapped onto
the port with the reference symbol it stands in for, so reference users
can find every capability one for one. This is a veneer — new code should
import the real modules.

Where the JAX package's target is a JAX-only object, the name maps to the
port's own equivalent:

- random draws: a ``torch.Generator`` in place of a ``jax.random`` key
  (``aug_tensor_color``, ``aug_array_color``, ``augColor``,
  ``aug_tensor_morph``, ``aug_array_morph`` take ``(generator, img)``);
- models: ``nn.Module`` s, which build their layers at construction and
  so need the input's channel count: builders whose reference signature
  has a channel or input-shape argument (``nchannels``, ``n_channels``,
  ``unet_dim``, ``lstm_dim``, ``acnn_dim``; a shape's last entry is its
  channels) require it, the others take a keyword ``in_channels``
  (``build_unet_layers``, ``get_siamese_layers``, ``binary_unet``,
  ``get_binary_model``, ``get_autoencoder``; the layer builders
  ``build_lstm_layers``/``build_acnn_layers`` pass ``in_ch`` through);
- weights: ``get_blob_model``/``get_blob_weights`` load into a model of the
  port (``target``) and return it, where JAX returned flax trees (so no
  ``batch_stats`` argument: the model holds its statistics);
- ``predict_chips``/``predict_chunk`` run on ``device`` (default CUDA;
  without CUDA they raise unless ``device="cpu"``), ``m`` a chip-batch
  function of tensors on that device.
"""

from __future__ import annotations

import collections as _collections
import functools as _functools

import numpy as _np
import torch as _torch

# --- utils/processing.py ---------------------------------------------------
from satellite_computervision_tpu_torch.data.matching import (  # noqa: F401
    get_file_id,      # processing.py:26
    match_files,      # processing.py:47
    split_files,      # processing.py:91
)
from satellite_computervision_tpu_torch.ops.bands import calc_ndvi  # noqa: F401  processing.py:116
from satellite_computervision_tpu_torch.ops import augment as _augment
from satellite_computervision_tpu_torch.ops.augment import (  # noqa: F401
    aug_morph as aug_tensor_morph,   # processing.py:169
    aug_morph as aug_array_morph,    # array_tools.py:186
)
from satellite_computervision_tpu_torch.ops.normalize import (  # noqa: F401
    normalize_image as normalize_tensor,   # processing.py:225
    rescale_image as rescale_tensor,       # processing.py:281
    normalize_timeseries,                  # array_tools.py:215
)
from satellite_computervision_tpu_torch.ops import normalize as _normalize


def aug_tensor_color(generator, img):
    """processing.py:129 — per-channel contrast/brightness recoloring, the
    multipliers drawn from ``generator``."""
    contra, bright = _augment.draw_color_params(generator, img.shape[-1])
    return _augment.aug_color(img, contra, bright)


def augColor(generator, img):  # noqa: N802 (the reference's name)
    """processing.py:154 — the HSV chain (hue, saturation, brightness,
    contrast), its draws from ``generator``."""
    return _augment.aug_color_hsv(img, *_augment.draw_hsv_params(generator))


# The reference's NumPy twins are NaN-aware (np.nanmean/np.nanstd/np.nanmin),
# normalize divides by std + eps and takes (mean, std) moment tuples, and
# aug_array_color draws scalar (not per-channel) multipliers
# (utils/array_tools.py:47-184) — bind those flavors explicitly.
normalize_array = _functools.partial(          # array_tools.py:47
    _normalize.normalize_image, nan_aware=True, std_form=True
)
rescale_array = _functools.partial(            # array_tools.py:109
    _normalize.rescale_image, nan_aware=True
)


def aug_array_color(generator, img):
    """array_tools.py:159 — NaN-aware recoloring with scalar multipliers
    shared across channels, drawn from ``generator``."""
    contra, bright = _augment.draw_color_params(generator, img.shape[-1], per_channel=False)
    return _augment.aug_color(img, contra, bright, nan_aware=True)


from satellite_computervision_tpu_torch.data.pipeline import (  # noqa: E402,F401
    make_preprocess_fn as to_tuple,        # processing.py:335 (batch form)
    get_training_dataset,                  # processing.py:421
    get_eval_dataset,                      # processing.py:443
)


def get_dataset(files, feature_names, kernel_size=256, compression="GZIP", workers=2):
    """processing.py:394 — the parsed (unshuffled, unbatched) chip stream;
    shuffle/batch/repeat live on get_training_dataset, as in the
    reference."""
    from satellite_computervision_tpu_torch.data.pipeline import ChipDataset

    return ChipDataset(files, feature_names, kernel_size, compression, workers=workers)


from satellite_computervision_tpu_torch.data.chip_generators import (  # noqa: E402,F401
    UNetChipDataset as UNETDataGenerator,              # processing.py:456
    SiameseChipDataset as SiameseDataGenerator,        # processing.py:757
    LSTMChipDataset as LSTMDataGenerator,              # processing.py:895
    LSTMAutoencoderChipDataset as LSTMAutoencoderGenerator,  # processing.py:974
    HybridChipDataset as HybridDataGenerator,          # processing.py:1051
    rearrange_timeseries,                              # processing.py:195
    split_timeseries,                                  # processing.py:209
)

# --- utils/array_tools.py --------------------------------------------------
from satellite_computervision_tpu_torch.ops.harmonics import (  # noqa: E402,F401
    make_harmonics,   # array_tools.py:12
    sin_cos,          # array_tools.py:283
    add_harmonic,     # array_tools.py:288
)
from satellite_computervision_tpu_torch.ops.classes import merge_classes  # noqa: E402,F401

# --- utils/model_tools.py --------------------------------------------------
from satellite_computervision_tpu_torch.models.losses import (  # noqa: E402,F401
    weighted_categorical_crossentropy,  # model_tools.py:25
    gen_dice,                           # model_tools.py:42
    weighted_bce,                       # model_tools.py:96
    iou_loss,                           # model_tools.py:131
    mse_4d,                             # model_tools.py:142
)
from satellite_computervision_tpu_torch.models.metrics import (  # noqa: E402,F401
    normalize_confusion_matrix,  # model_tools.py:1111
)
from satellite_computervision_tpu_torch.models.blocks import (  # noqa: E402,F401
    ConvBNAct as conv_batch_act,  # model_tools.py:174
    ConvBlock as conv_block,      # model_tools.py:211
    EncoderBlock as encoder_block,  # model_tools.py:262
    DecoderBlock as decoder_block,  # model_tools.py:288
    ASPP as DilatedSpatialPyramidPooling,  # model_tools.py:533
)


def _channels(dim, name: str) -> int:
    """A channel count from the reference's channel or input-shape argument
    (a shape's last entry)."""
    if dim is None:
        raise ValueError(f"{name}: the port builds its layers at construction — pass the "
                         "input's channel count (or its shape)")
    return int(dim[-1]) if isinstance(dim, (tuple, list)) else int(dim)


# The reference's functional-style layer builders return Keras tensors
# wired into a graph (model_tools.py:321,576,666,719,922,941); here each
# returns the corresponding module — call it (or hold it inside a parent
# module) instead of threading tensors through it.


def build_unet_layers(filters=(32, 64, 128, 256, 512), factors=(2, 2, 2, 2, 2),
                      dropout=None, *, in_channels, **kwargs):
    """model_tools.py:321 — the U-Net trunk as a module (linear head; add
    your own head conv as the reference's get_*_model wrappers do)."""
    from satellite_computervision_tpu_torch.models import UNet

    return UNet(in_channels, n_classes=1, head="linear", filters=tuple(filters),
                factors=tuple(factors), dropout=dropout, **kwargs)


def get_siamese_layers(filters=(32, 64, 128), factors=(2, 2, 2), *, in_channels, **kwargs):
    """model_tools.py:576 — the shared-encoder siamese trunk as a module
    (make_siamese_unet adds the sigmoid head; here threshold/bias are
    left at defaults)."""
    from satellite_computervision_tpu_torch.models import SiameseUNet

    return SiameseUNet(in_channels, filters=tuple(filters), factors=tuple(factors), **kwargs)


def build_lstm_layers(**kwargs):
    """model_tools.py:666 — 2x ConvLSTM2D stack as a module (``in_ch``,
    ``features``)."""
    from satellite_computervision_tpu_torch.models.convlstm import LSTMStack

    return LSTMStack(**kwargs)


def build_lstm_layers2(**kwargs):
    """model_tools.py:719 — state-returning residual ConvLSTM variant."""
    from satellite_computervision_tpu_torch.models.convlstm import LSTMStack2

    return LSTMStack2(**kwargs)


def build_acnn_layers(nfilters=16, depth=16, **kwargs):
    """model_tools.py:922 — atrous-CNN residual trunk as a module
    (variant-1 wiring: the plain conv takes the raw dilated-conv output)."""
    from satellite_computervision_tpu_torch.models.acnn import ACNNTrunk

    kwargs.setdefault("variant", 1)
    return ACNNTrunk(features=nfilters, n_blocks=depth, **kwargs)


def build_acnn_layers2(nfilters=16, depth=16, **kwargs):
    """model_tools.py:941 — variant-2 wiring (the plain conv takes the
    activated output)."""
    from satellite_computervision_tpu_torch.models.acnn import ACNNTrunk

    kwargs.setdefault("variant", 2)
    return ACNNTrunk(features=nfilters, n_blocks=depth, **kwargs)


def get_unet_model(nclasses, nchannels=None, filters=(32, 64, 128, 256, 512),
                   factors=(2, 2, 2, 2, 2), bias=None, dropout=None, **kwargs):
    """model_tools.py:394 — multiclass softmax U-Net."""
    from satellite_computervision_tpu_torch.models import UNet

    return UNet(_channels(nchannels, "nchannels"), n_classes=nclasses, filters=tuple(filters),
                factors=tuple(factors), head="softmax", output_bias=bias, dropout=dropout,
                **kwargs)


def binary_unet(bias=None, threshold=0.5, *, in_channels, **kwargs):
    """model_tools.py:417 — fixed 5-level binary U-Net."""
    from satellite_computervision_tpu_torch.models import UNet

    return UNet(in_channels, n_classes=1, head="sigmoid", threshold=threshold,
                output_bias=bias, **kwargs)


get_binary_model = binary_unet  # model_tools.py:456


def get_autoencoder(nclasses=1, *, in_channels, **kwargs):
    """model_tools.py:496 — linear-head U-Net."""
    from satellite_computervision_tpu_torch.models import UNet

    return UNet(in_channels, n_classes=nclasses, head="linear", **kwargs)


def make_siamese_unet(n_channels=None, filters=(32, 64, 128), factors=(2, 2, 2),
                      bias=None, class_thresh=0.5, **kwargs):
    """model_tools.py:638."""
    from satellite_computervision_tpu_torch.models import SiameseUNet

    return SiameseUNet(_channels(n_channels, "n_channels"), filters=tuple(filters),
                       factors=tuple(factors), threshold=class_thresh, output_bias=bias,
                       **kwargs)


def get_lstm_model(n_channels=None, n_classes=1, n_time=None, dropout=None, **kwargs):
    """model_tools.py:773."""
    from satellite_computervision_tpu_torch.models import LSTMModel

    return LSTMModel(_channels(n_channels, "n_channels"), n_classes, dropout=dropout, **kwargs)


def get_lstm_autoencoder(n_channels=None, n_time=6, n_classes=1, **kwargs):
    """model_tools.py:810."""
    from satellite_computervision_tpu_torch.models import LSTMAutoencoder

    return LSTMAutoencoder(_channels(n_channels, "n_channels"), n_classes, n_time, **kwargs)


def get_hybrid_model(unet_dim=None, lstm_dim=None, n_classes=8,
                     filters=(32, 64, 128, 256), factors=(3, 2, 2, 2),
                     dropout=None, **kwargs):
    """model_tools.py:874."""
    from satellite_computervision_tpu_torch.models import HybridUNetLSTM

    return HybridUNetLSTM(_channels(unet_dim, "unet_dim"), _channels(lstm_dim, "lstm_dim"),
                          n_classes, filters=tuple(filters), factors=tuple(factors),
                          dropout=dropout, **kwargs)


def get_acnn_model(nclasses, nfilters=16, nchannels=None, depth=16, **kwargs):
    """model_tools.py:981 (variant-1 wiring)."""
    from satellite_computervision_tpu_torch.models import ACNN

    return ACNN(_channels(nchannels, "nchannels"), nclasses, n_blocks=depth, features=nfilters,
                **kwargs)


def get_acnn_model2(nclasses, nchannels=None, nfilters=16, depth=16, **kwargs):
    """model_tools.py:992 (variant-2 wiring)."""
    from satellite_computervision_tpu_torch.models import ACNN

    return ACNN(_channels(nchannels, "nchannels"), nclasses, n_blocks=depth, features=nfilters,
                **kwargs)


def get_hierarchical_model(nclasses, acnn_nclasses, acnn_sub_nclasses,
                           acnn_dim=None, lstm_dim=None, nfilters=16, depth=16, **kwargs):
    """model_tools.py:1016."""
    from satellite_computervision_tpu_torch.models import HierarchicalACNN

    return HierarchicalACNN(
        _channels(acnn_dim, "acnn_dim"), _channels(lstm_dim, "lstm_dim"), nclasses,
        acnn_nclasses, acnn_sub_nclasses, n_blocks=depth, features=nfilters, **kwargs,
    )


def retrain_model(*args, **kwargs):
    """model_tools.py:1128 — see train.retrain.retrain."""
    from satellite_computervision_tpu_torch.train.retrain import retrain

    return retrain(*args, **kwargs)


def get_blob_weights(url, target):
    """model_tools.py:1178 — a flax msgpack blob (https, or file://) into
    the model ``target``, returned."""
    from satellite_computervision_tpu_torch.train.checkpoint import load_remote_weights

    return load_remote_weights(url, target)


def get_blob_model(model_url=None, weights_url=None, target=None, family: str = "unet"):
    """model_tools.py:1204 — remote model restore into ``target``, a model
    of the port, which is returned.

    The reference streams Keras ``.h5``/``.hdf5`` blobs from Azure over
    https; URLs ending in those suffixes are fetched and mapped through
    train.keras_import (``target`` a ``UNet(convs_per_block=1)``, or of the
    ``family`` ``siamese``, ``lstm``/``convlstm``, ``lstm_autoencoder`` or
    ``hybrid``). Anything else restores the JAX package's msgpack blobs."""
    url = weights_url or model_url
    if url.split("?")[0].lower().endswith((".h5", ".hdf5")):
        from satellite_computervision_tpu_torch.train import keras_import

        loaders = {
            "siamese": keras_import.load_keras_siamese_h5,
            "lstm": keras_import.load_keras_lstm_h5,
            "convlstm": keras_import.load_keras_lstm_h5,
            "lstm_autoencoder": keras_import.load_keras_lstm_autoencoder_h5,
            "hybrid": keras_import.load_keras_hybrid_h5,
        }
        return loaders.get(family, keras_import.load_keras_unet_h5)(url, target)
    return get_blob_weights(url, target)


def predict_chunk(data, m=None, model=None, output_key: str = "probs",
                  model_blob_url=None, weights_blob_url=None, family: str = "unet",
                  device="cuda"):
    """model_tools.py:1271 — the Dask-worker chunk predictor: a (C, H, W)
    chunk -> HWC -> predict -> squeezed numpy output.

    ``m`` is a chip-batch predict function with its weights already on
    ``device`` (the fix for the reference's per-chunk model re-download).
    The blob-URL form takes a ``model`` of the port, restores it once
    through get_blob_model, moves it to ``device`` and reads
    ``output_key``."""
    from satellite_computervision_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    if m is None:
        if model is None or not (model_blob_url or weights_blob_url):
            raise ValueError("pass a predict fn `m`, or a model and a blob URL")
        net = get_blob_model(model_blob_url, weights_blob_url, target=model,
                             family=family).to(dev).eval()

        def m(chips):
            with _torch.inference_mode():
                return net(chips)[output_key]

    hwc = _torch.as_tensor(_np.asarray(data)).to(dev).permute(1, 2, 0)
    pred = m(hwc[None])[0]
    return _np.squeeze(pred.detach().float().cpu().numpy())


# --- utils/prediction_tools.py --------------------------------------------
from satellite_computervision_tpu_torch.ops.chips import (  # noqa: E402,F401
    generate_chip_indices,  # prediction_tools.py:87 / raster_tools.py:23
    extract_chips,          # prediction_tools.py:111 / raster_tools.py:48
)

# Bounded LRU of engines: an unbounded dict keyed on the predict-fn object
# would keep every engine forever, and a caller passing a fresh lambda per
# call would grow it without limit.
_PREDICT_ENGINES: "_collections.OrderedDict" = _collections.OrderedDict()
_PREDICT_ENGINES_MAX = 8


def predict_chips(arr, chip_indices, template, m, kernel=256, buff=128, cache_key=None,
                  device="cuda"):
    """prediction_tools.py:133 — the reference's per-chip loop as one
    ``TiledInferenceEngine`` pass (``blend="sum"``, the reference's index
    grid; ``chip_indices`` is implied by it). ``m`` is a chip-batch predict
    function.

    Engines are kept per (predict fn or ``cache_key``, geometry, device) in
    a small LRU, so repeated calls with one model and chip geometry reuse
    one engine; callers that build a fresh lambda per call pass a stable
    ``cache_key``."""
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine

    out_channels = template.shape[-1] if template.ndim == 3 else 1
    key = (cache_key if cache_key is not None else m, kernel, buff, out_channels, str(device))
    engine = _PREDICT_ENGINES.get(key)
    if engine is None:
        engine = TiledInferenceEngine(m, kernel=kernel, buffer=buff, batch_size=16,
                                      out_channels=out_channels, blend="sum",
                                      index_mode="reference", device=device)
        _PREDICT_ENGINES[key] = engine
        while len(_PREDICT_ENGINES) > _PREDICT_ENGINES_MAX:
            _PREDICT_ENGINES.popitem(last=False)
    else:
        _PREDICT_ENGINES.move_to_end(key)
    return engine.predict_scene(arr)


from satellite_computervision_tpu_torch.inference.batch import (  # noqa: E402,F401
    make_pred_batches as make_pred_dataset,   # prediction_tools.py:159
    run_batch_prediction as doPrediction,     # prediction_tools.py:602
    get_img_bounds,                           # prediction_tools.py:560
)
from satellite_computervision_tpu_torch.inference.mixer import (  # noqa: E402,F401
    reassemble_patches as make_array_predictions,  # prediction_tools.py:293
    reassemble_patches as callback_predictions,    # prediction_tools.py:245
    read_mixer,
)
from satellite_computervision_tpu_torch.inference.writers import (  # noqa: E402,F401
    write_tfrecord_predictions,   # prediction_tools.py:375
    write_geotiff_predictions,    # prediction_tools.py:475 (streaming form)
    write_geotiff_predictions as write_geotiff_prediction,  # prediction_tools.py:447
)
from satellite_computervision_tpu_torch.utils.viz import plot_to_image  # noqa: E402,F401

# --- utils/raster_tools.py -------------------------------------------------
from satellite_computervision_tpu_torch.geo.transforms import (  # noqa: E402,F401
    convert_yolo_bbox as convert,   # raster_tools.py:70
    make_window,                    # raster_tools.py:98
    geo_transform_from_mixer as get_geo_transform,  # raster_tools.py:120
    convert_poly_coords,            # raster_tools.py:144
    convert_pt,                     # raster_tools.py:216
    win_jitter,                     # raster_tools.py:235
    polygon_centroid as get_centroid,  # raster_tools.py:251
    make_jittered_window,           # raster_tools.py:287
)
from satellite_computervision_tpu_torch.utils.viz import (  # noqa: E402,F401
    save_rgb_image as rasterio_to_img,  # raster_tools.py:333
)
from satellite_computervision_tpu_torch.geo.assembly import (  # noqa: E402,F401
    numpy_to_raster,  # raster_tools.py:367
    arrays_to_cog,    # raster_tools.py:411
)

# --- utils/ee_tools.py (on-device math; server-side client in cloud.ee) ----
from satellite_computervision_tpu_torch.cloud.masking import (  # noqa: E402,F401
    norm_p,                # ee_tools.py:9
    chi_p,                 # ee_tools.py:21
    gamma_p,               # ee_tools.py:31
    normalize_minmax as normalize,  # ee_tools.py:39
    standardize,           # ee_tools.py:52
    lda_score as ldaScore,  # ee_tools.py:73
    sentinel2toa,          # ee_tools.py:90
    rescale,               # ee_tools.py:110
    water_score as waterScore,   # ee_tools.py:115
    basic_qa_mask as basicQA,    # ee_tools.py:159
    landsat8_sr_mask as maskL8sr,  # ee_tools.py:183
    cloud_bands as cloudBands,   # ee_tools.py:198
    dark_channels as darkC,      # ee_tools.py:206
    sentinel_cloud_score as sentinelCloudScore,  # ee_tools.py:218
    scl_mask as maskSR,          # ee_tools.py:270
    toa_mask as maskTOA,         # ee_tools.py:289
    combined_mask as mask,       # ee_tools.py:257 (CDI/JRC planes optional)
)

# --- utils/calibration.py --------------------------------------------------
from satellite_computervision_tpu_torch.cloud.calibration import (  # noqa: E402,F401
    clamp_and_scale,       # calibration.py:12
    scene_median,          # calibration.py:47
    overlap_mask as get_overlap,  # calibration.py:64
    histogram_cdf as hist_to_FC,  # calibration.py:78
    make_FC,               # calibration.py:105 (per-band (bucket_means, cdf) list)
    equalize_scene as equalize,   # calibration.py:136 (exact CDF-interp form)
    equalize_rf,           # calibration.py:136 (the shipped chained-RF form)
    equalize_collection,   # calibration.py:184
)

# --- utils/pc_tools.py -----------------------------------------------------
from satellite_computervision_tpu_torch.cloud.pc import (  # noqa: E402,F401
    retry as recursive_api_try,   # pc_tools.py:44 (bounded, unlike the ref)
    resign_vrt,                   # pc_tools.py:55 (pure-XML, no GDAL)
    harmonize_to_old,             # pc_tools.py:284
    normalize_xarray as normalize_dataArray,  # pc_tools.py:90
    trim_to_chunk_multiple as trim_dataArray,  # pc_tools.py:109
    get_naip_stac,                # pc_tools.py:131
    get_dem_stac,                 # pc_tools.py:188
    get_hag_stac,                 # pc_tools.py:224
    get_s2_stac,                  # pc_tools.py:328
    get_s1_stac,                  # pc_tools.py:388
    get_ssurgo_stac,              # pc_tools.py:496
    join_ssurgo,                  # pc_tools.py:544
    predict_scene as run_local,   # pc_tools.py:620
    predict_scene as run_dask,    # pc_tools.py:670 (mesh replaces Dask)
    predict_scene as predict_pc_local,  # prediction_tools.py:731 (= run_local)
    predict_scene as predict_pc_dask,   # prediction_tools.py:781 (= run_dask)
)
from satellite_computervision_tpu_torch.cloud.blob import (  # noqa: E402,F401
    save_numpy as export_blob,  # pc_tools.py:83
)
from satellite_computervision_tpu_torch.cloud.compositing import (  # noqa: E402,F401
    mosaic_tiles as naip_mosaic,          # pc_tools.py:264 (array-level)
    composite_items as get_pc_imagery,    # pc_tools.py:564 (median composite core)
    stack_items,
    median_composite,
    change_pair_composite,
)

# --- utils/stats.py --------------------------------------------------------
from satellite_computervision_tpu_torch.ops.stats import (  # noqa: E402,F401
    gamma_pdf,      # stats.py:4
    lognormal_pdf,  # stats.py:25
)
