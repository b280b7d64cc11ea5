"""Model-zoo registry: a model family's builder, example inputs and labels
and default loss, so the training CLI builds through one place.

Port of ``satellite_computervision_tpu/train/zoo.py``, all eight families:
``unet`` (the ``solar`` and ``parking`` configs), ``deeplab`` (DeepLab v3+
on a ResNet-50), ``siamese`` (``change``; before and after), ``convlstm``
and ``lstm_autoencoder`` (``timeseries``), ``hybrid``, ``acnn`` and
``hierarchical`` (``landcover``, ``wetland``); and one family of the port's
own, ``prithvi`` (the Prithvi-EO-2.0 ViT encoder with a segmentation head,
``models/prithvi.py``), which the JAX package does not have.

The JAX modules infer their input channels at ``init``; the port's take
them at construction: images and series have ``len(cfg.bands)``
channels, the width of the JAX zoo's example inputs, which the JAX
package's CLI initializes from (``in_channels`` / ``series_channels``
override).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from satellite_computervision_tpu_torch.models import flax_init_, losses
from satellite_computervision_tpu_torch.models.prithvi import mae_init_


@dataclasses.dataclass(frozen=True)
class Family:
    """One model family: ``build(cfg, **kw)``, ``example_inputs(cfg)``
    (positional numpy inputs), ``example_labels(cfg)`` (the matching
    target structure), ``loss(cfg) -> (loss_fn, pred_key)``, where
    ``pred_key=None`` hands the whole output dict to ``loss_fn``
    (multi-head families), and ``init(model, generator)``, which draws
    every weight and statistic from the seed (the JAX CLI's flax
    initialisation; MAE's for the ViT)."""

    name: str
    build: Callable
    example_inputs: Callable
    example_labels: Callable
    loss: Callable
    init: Callable = flax_init_


def _bce(cfg):
    pos = cfg.loss_kwargs.get("pos_weight", 1.0) if cfg else 1.0
    return (lambda y, p: losses.weighted_bce(y, p, pos_weight=pos, logits=True)), "logits"


def _wcce(cfg):
    w = np.ones(cfg.num_classes if cfg else 8, np.float32)
    return (lambda y, p: losses.weighted_categorical_crossentropy(
        y, p, w, reduce_mean=True)), "probs"


def _channels(cfg, default):
    return len(cfg.bands) if cfg else default


def _build_unet(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import UNet

    n = cfg.num_classes if cfg else 1
    kw.setdefault("head", "sigmoid" if n == 1 else "softmax")
    kw.setdefault("threshold", cfg.threshold if cfg else 0.5)
    # the config's stem (SOLAR_CONFIG trains space-to-depth from scratch);
    # an explicit kw wins
    kw.setdefault("space_to_depth", bool(getattr(cfg, "space_to_depth", False)))
    in_channels = kw.pop("in_channels", len(cfg.bands) if cfg else 4)
    return UNet(in_channels, n_classes=n, **kw)


def _build_deeplab(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import DeepLabV3Plus

    n = cfg.num_classes if cfg else 1
    kw.setdefault("head", "sigmoid" if n == 1 else "softmax")
    kw.setdefault("threshold", cfg.threshold if cfg else 0.5)
    in_channels = kw.pop("in_channels", len(cfg.bands) if cfg else 4)
    return DeepLabV3Plus(in_channels, n_classes=n, **kw)


def _build_siamese(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import SiameseUNet

    kw.setdefault("threshold", cfg.threshold if cfg else 0.5)
    in_channels = kw.pop("in_channels", len(cfg.bands) if cfg else 4)
    return SiameseUNet(in_channels, **kw)


def _build_lstm(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import LSTMModel

    in_channels = kw.pop("in_channels", _channels(cfg, 6))
    return LSTMModel(in_channels, n_classes=cfg.num_classes if cfg else 1, **kw)


def _build_lstm_ae(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import LSTMAutoencoder

    kw.setdefault("n_time", getattr(cfg, "n_time", 6) if cfg else 6)
    in_channels = kw.pop("in_channels", _channels(cfg, 6))
    return LSTMAutoencoder(in_channels, n_classes=cfg.num_classes if cfg else 1, **kw)


def _build_hybrid(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import HybridUNetLSTM

    in_channels = kw.pop("in_channels", _channels(cfg, 4))
    series_channels = kw.pop("series_channels", _channels(cfg, 6))
    return HybridUNetLSTM(in_channels, series_channels,
                          n_classes=cfg.num_classes if cfg else 8, **kw)


def _build_acnn(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import ACNN

    in_channels = kw.pop("in_channels", _channels(cfg, 4))
    return ACNN(in_channels, n_classes=cfg.num_classes if cfg else 8, **kw)


def _build_hierarchical(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models import HierarchicalACNN

    n = cfg.num_classes if cfg else 8
    kw.setdefault("acnn_classes", n)
    kw.setdefault("sub_classes", max(2, n // 2))
    in_channels = kw.pop("in_channels", _channels(cfg, 4))
    series_channels = kw.pop("series_channels", _channels(cfg, 6))
    return HierarchicalACNN(in_channels, series_channels, n_classes=n, **kw)


def _build_prithvi(cfg=None, **kw):
    from satellite_computervision_tpu_torch.models.prithvi import PrithviSegmenter

    n = cfg.num_classes if cfg else 1
    kw.setdefault("head", "sigmoid" if n == 1 else "softmax")
    kw.setdefault("threshold", cfg.threshold if cfg else 0.5)
    # a config's chips are one date of its bands unless ``frames`` says more
    kw.setdefault("frames", 1)
    in_channels = kw.pop("in_channels", _channels(cfg, 6) * kw["frames"])
    return PrithviSegmenter(in_channels, n_classes=n, **kw)


def _img(cfg, k=None, c=None):
    k = k or (cfg.kernel_size if cfg else 32)
    c = c or _channels(cfg, 4)
    return np.zeros((1, k, k, c), np.float32)


def _series(cfg, t=None, k=32, c=None):
    t = t or (getattr(cfg, "n_time", 6) if cfg else 6)
    c = c or _channels(cfg, 6)
    return np.zeros((1, t, k, k, c), np.float32)


def _onehot_labels(cfg, k=None):
    n = cfg.num_classes if cfg else 8
    k = k or (cfg.kernel_size if cfg else 32)
    y = np.zeros((1, k, k, n), np.float32)
    y[..., 0] = 1.0
    return y


def _map_labels(cfg, k=None, c=None):
    k = k or (cfg.kernel_size if cfg else 32)
    return np.zeros((1, k, k, c or max(1, cfg.num_classes if cfg else 1)), np.float32)


def _lstm_ae_loss(cfg=None):
    def loss_fn(y, out):
        temporal_y, single_y = y
        temporal = out["temporal"]
        return losses.mse_4d(single_y, out["single"]) + losses.mse_4d(
            temporal_y.reshape((-1,) + tuple(temporal_y.shape[2:])),
            temporal.reshape((-1,) + tuple(temporal.shape[2:])))

    return loss_fn, None


def _hierarchical_loss(cfg=None):
    n = cfg.num_classes if cfg else 8
    sub = max(2, n // 2)
    w_n, w_sub = np.ones(n, np.float32), np.ones(sub, np.float32)

    def loss_fn(y, out):
        y_main, y_sub = y
        wcce = losses.weighted_categorical_crossentropy
        return (wcce(y_main, out["lstm_probs"], w_n, reduce_mean=True)
                + wcce(y_main, out["acnn_probs"], w_n, reduce_mean=True)
                + wcce(y_sub, out["sub_probs"], w_sub, reduce_mean=True))

    return loss_fn, None


def _deeplab_side(cfg):
    # output stride 16 and the C2 decoder need a side of at least 64
    return max(64, cfg.kernel_size if cfg else 64)


FAMILIES = {
    "unet": Family(
        "unet", _build_unet,
        lambda cfg: (_img(cfg),),
        _map_labels,
        _bce,  # every unet preset, multi-class too, as the JAX zoo trains it
    ),
    "deeplab": Family(
        "deeplab", _build_deeplab,
        lambda cfg: (_img(cfg, k=_deeplab_side(cfg)),),
        lambda cfg: _map_labels(cfg, k=_deeplab_side(cfg)),
        _bce,
    ),
    "siamese": Family(
        "siamese", _build_siamese,
        lambda cfg: (_img(cfg), _img(cfg)),  # before, after
        lambda cfg: _map_labels(cfg, c=1),
        _bce,
    ),
    "convlstm": Family(
        "convlstm", _build_lstm,
        lambda cfg: (_series(cfg),),
        lambda cfg: _map_labels(cfg, k=32),
        lambda cfg: ((lambda y, p: losses.mse_4d(y, p)), None),
    ),
    "lstm_autoencoder": Family(
        "lstm_autoencoder", _build_lstm_ae,
        # the series, and the sin/cos harmonics of the single-step head
        lambda cfg: (_series(cfg), np.zeros((1, 32, 32, 2), np.float32)),
        lambda cfg: (_series(cfg, c=max(1, cfg.num_classes if cfg else 1)),
                     _map_labels(cfg, k=32)),
        _lstm_ae_loss,
    ),
    "hybrid": Family(
        "hybrid", _build_hybrid,
        lambda cfg: (_img(cfg), _series(cfg, k=32)),
        _onehot_labels,
        _wcce,
    ),
    "acnn": Family(
        "acnn", _build_acnn,
        lambda cfg: (_img(cfg),),
        _onehot_labels,
        _wcce,
    ),
    "hierarchical": Family(
        "hierarchical", _build_hierarchical,
        lambda cfg: (_img(cfg), _series(cfg, k=cfg.kernel_size if cfg else 32)),
        lambda cfg: (_onehot_labels(cfg),
                     _map_labels(cfg, c=max(2, (cfg.num_classes if cfg else 8) // 2))),
        _hierarchical_loss,
    ),
    "prithvi": Family(
        "prithvi", _build_prithvi,
        lambda cfg: (_img(cfg),),
        _map_labels,
        _bce,
        mae_init_,
    ),
}


def get_family(name: str) -> Family:
    if name not in FAMILIES:
        raise KeyError(f"unknown model family {name!r}; choose from {sorted(FAMILIES)}")
    return FAMILIES[name]
