"""The port's multi-source U-Net, timeseries and hybrid chip datasets
(data/chip_generators.py) against the JAX package's on the same ``.npy``
files: ``rearrange_timeseries`` / ``split_timeseries``,
``LSTMChipDataset``, ``LSTMAutoencoderChipDataset``, ``UNetChipDataset``
and ``HybridChipDataset``.

The shuffle order, the NaN fills and the sequence rotations come from the
shared ``np.random.default_rng(seed)`` and match exactly. The JAX
datasets' colour and morph draws (their key chain) are injected into the
port's ``draw_color_params`` / ``draw_morph_params`` in call order, and the
batches then agree within 1e-6 (the channel means summed in another
order; inputs in [0, 1]); labels, series without colour augmentation and
predict-mode batches are equal exactly, harmonics within 1e-6 (float32
sin/cos of two libraries)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.data import chip_generators as jcg
from satellite_computervision_tpu.ops.augment import draw_morph_params as jax_draw_morph
from satellite_computervision_tpu_torch.data import chip_generators as cg

SEED, BATCH, N = 3, 2, 6


class JaxDraws:
    """Replays a JAX chip dataset's key chain: each colour or morph draw
    takes the next ``jax.random.split`` of ``key(seed)``, as
    ``_BaseChipDataset._next_key`` does."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)
        self.calls = {"color": 0, "morph": 0}

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def color(self, gen, n_ch):
        self.calls["color"] += 1
        ckey, bkey = jax.random.split(self._next())
        return tuple(torch.from_numpy(np.array(jax.random.uniform(
            k, (n_ch,), minval=0.95, maxval=1.05, dtype=jnp.float32))) for k in (ckey, bkey))

    def morph(self, gen):
        self.calls["morph"] += 1
        return tuple(int(p) for p in jax_draw_morph(self._next()))


@pytest.fixture
def jax_draws(monkeypatch):
    draws = JaxDraws(SEED)
    monkeypatch.setattr(cg, "draw_color_params", draws.color)
    monkeypatch.setattr(cg, "draw_morph_params", draws.morph)
    return draws


def _save(path, arr):
    np.save(path, arr)
    return str(path)


def _series(root, rng, n=N, t=6, c=4, dim=12, month=True, scale=10000.0):
    root.mkdir(exist_ok=True)
    files = []
    for i in range(n):
        arr = (rng.uniform(0, 1, (t, c, dim, dim)) * scale).astype(np.float32)
        arr[1, 0, :2, :3] = np.nan
        if i == 0:
            arr[2] = 0.0  # a rotation that ends here has an all-zero label: rotate again
        name = f"s2_x_{(i * 5) % 12}_{i:03d}.npy" if month else f"s1_{i:03d}.npy"
        files.append(_save(root / name, arr))
    return files


def _sources(tmp_path, rng, dim=12, nan=True):
    """naip (4 bands, one chip HWC), hag (1 band with < -5000 and, with
    ``nan``, NaN pixels: masked, and filled when fitting), labels with the
    reference's transition classes, land-use planes."""
    out = {name: [] for name in ("naip", "hag", "label", "lu")}
    for name in out:
        (tmp_path / name).mkdir()
    for i in range(N):
        naip = (rng.uniform(0, 1, (4, dim, dim)) * 255).astype(np.float32)
        if i == 2:
            naip = np.moveaxis(naip, 0, -1)
        hag = (rng.uniform(0, 1, (1, dim, dim)) * 100).astype(np.float32)
        if nan:
            hag[0, 3:5, 4:8] = np.nan
        hag[0, 8, 1:3] = -9999.0
        label = rng.choice([0, 1, 2, 5, 9, 10, 11, 12, 255], size=(1, dim, dim)).astype(np.uint8)
        lu = rng.choice([0, 0, 0, 82, 84], size=(1, dim, dim)).astype(np.uint8)
        for name, arr in (("naip", naip), ("hag", hag), ("label", label), ("lu", lu)):
            out[name].append(_save(tmp_path / name / f"{name}_{i:03d}.npy", arr))
    return out


def _equal(got, want, atol=0.0):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if atol:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


def test_rearrange_and_split_match_jax():
    batch = np.random.default_rng(0).normal(size=(2, 5, 4, 4, 3)).astype(np.float32)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(4):
        (got, start), (want, jstart) = (cg.rearrange_timeseries(batch, rng),
                                        jcg.rearrange_timeseries(batch, jrng))
        assert start == jstart
        _equal(got, want)
        for g, w in zip(cg.split_timeseries(got, 2), jcg.split_timeseries(want, 2)):
            _equal(g, w)


@pytest.mark.parametrize("to_fit", [True, False], ids=["fit", "predict"])
def test_lstm_dataset_matches_jax(tmp_path, rng, to_fit):
    files = _series(tmp_path / "s2", rng)
    kw = dict(batch_size=BATCH, dim=(8, 8), n_channels=3, n_timesteps=6, seed=SEED,
              to_fit=to_fit)
    ds, jds = cg.LSTMChipDataset(files, **kw), jcg.LSTMChipDataset(files, **kw)
    assert len(ds) == len(jds) == N // BATCH
    for _epoch in range(2):
        for got, want in zip(list(ds), list(jds)):
            if to_fit:
                assert got[0].shape == (BATCH, 5, 8, 8, 4) and got[1].shape == (BATCH, 8, 8, 3)
                for g, w in zip(got, want):
                    _equal(g, w)
            else:
                _equal(got, want)
        np.testing.assert_array_equal(ds.indexes, jds.indexes)


def test_lstm_dataset_raises_on_all_empty_labels(tmp_path):
    files = [_save(tmp_path / f"s2_x_1_{i}.npy", np.zeros((6, 4, 8, 8), np.float32))
             for i in range(2)]
    kw = dict(batch_size=2, dim=(8, 8), n_timesteps=6, seed=0)
    for cls in (cg.LSTMChipDataset, jcg.LSTMChipDataset):
        with pytest.raises(ValueError, match="all-empty next-step labels after 8"):
            cls(files, **kw)[0]
        assert cls(files, to_fit=False, **kw)[0].shape == (2, 6, 8, 8, 4)


@pytest.mark.parametrize("sample_weights", [False, True])
@pytest.mark.parametrize("to_fit", [True, False], ids=["fit", "predict"])
def test_lstm_autoencoder_dataset_matches_jax(tmp_path, rng, to_fit, sample_weights):
    files = _series(tmp_path / "s2", rng, t=7)
    kw = dict(batch_size=BATCH, dim=(8, 8), n_channels=4, n_timesteps=6, seed=SEED,
              to_fit=to_fit, sample_weights=sample_weights)
    ds, jds = cg.LSTMAutoencoderChipDataset(files, **kw), jcg.LSTMAutoencoderChipDataset(
        files, **kw)
    for got, want in zip(list(ds), list(jds)):
        if not to_fit:
            _equal(got[0], want[0])  # all 7 steps
            _equal(got[1], want[1], atol=1e-6)  # harmonics of the files' months
            continue
        (feats, harm), (temporal_y, y), weights = got
        (jfeats, jharm), (jtemporal_y, jy), jweights = want
        assert feats.shape == (BATCH, 6, 8, 8, 4) and harm.shape == (BATCH, 8, 8, 2)
        _equal(feats, jfeats)
        _equal(np.ascontiguousarray(temporal_y), np.asarray(jtemporal_y))
        np.testing.assert_array_equal(temporal_y, feats[:, ::-1])
        _equal(y, jy)
        _equal(harm, jharm, atol=1e-6)
        if sample_weights:
            assert weights[0] is None and jweights[0] is None
            np.testing.assert_array_equal(weights[1], jweights[1])
        else:
            assert weights is None and jweights is None


@pytest.mark.parametrize("to_fit", [True, False], ids=["fit", "predict"])
def test_unet_dataset_matches_jax(tmp_path, rng, jax_draws, to_fit):
    # a NaN is filled only when fitting; in predict mode it raises in both
    tree = _sources(tmp_path, rng, nan=to_fit)
    s2 = [_save(tmp_path / f"s2_{i}.npy",
                (rng.uniform(0, 1, (4, 12, 12)) * 10000).astype(np.float32)) for i in range(N)]

    def sources(mod):
        return {"naip": mod.ChipSource.named("naip", tree["naip"]),
                "hag": mod.ChipSource.named("hag", tree["hag"]),
                "s2": mod.ChipSource.named("s2", s2)}

    assert cg.ChipSource.named("s1", s2).divisor == -50.0
    assert cg.RESCALE_DIVISORS == jcg.RESCALE_DIVISORS
    kw = dict(label_files=tree["label"], lu_files=tree["lu"], batch_size=BATCH,
              unet_dim=(8, 8), n_classes=11, seed=SEED, to_fit=to_fit)
    ds, jds = cg.UNetChipDataset(sources(cg), **kw), jcg.UNetChipDataset(sources(jcg), **kw)
    for _epoch in range(2):
        for got, want in zip(list(ds), list(jds)):
            if not to_fit:
                _equal(got, want)
                continue
            # naip 4 + hag 1 + its mask 1 + s2 4
            assert got[0].shape == (BATCH, 8, 8, 10) and got[1].shape == (BATCH, 8, 8, 11)
            _equal(got[0], want[0], atol=1e-6)
            _equal(got[1], want[1])
            np.testing.assert_array_equal(got[1].sum(-1), 1.0)
    n_batches = 2 * len(ds)
    assert jax_draws.calls == ({"color": 2 * n_batches, "morph": n_batches} if to_fit
                               else {"color": 0, "morph": 0})
    if not to_fit:
        hag = np.load(tree["hag"][0])
        hag[0, 0, 0] = np.nan
        np.save(tree["hag"][0], hag)
        for d in (cg.UNetChipDataset(sources(cg), **kw), jcg.UNetChipDataset(sources(jcg), **kw)):
            with pytest.raises(ValueError, match="NaNs in batch"):
                list(d)


@pytest.mark.parametrize("with_s1", [False, True], ids=["s2", "s2+s1"])
@pytest.mark.parametrize("to_fit", [True, False], ids=["fit", "predict"])
def test_hybrid_dataset_matches_jax(tmp_path, rng, jax_draws, to_fit, with_s1):
    tree = _sources(tmp_path, rng, dim=16, nan=to_fit)
    s2 = _series(tmp_path / "s2", rng, dim=10)
    s1 = _series(tmp_path / "s1", rng, c=2, dim=10, month=False, scale=-25.0) if with_s1 \
        else None

    def sources(mod):
        return {"naip": mod.ChipSource.named("naip", tree["naip"]),
                "hag": mod.ChipSource.named("hag", tree["hag"])}

    kw = dict(s2_series_files=s2, s1_series_files=s1, lstm_dim=(6, 8, 8, 6),
              label_files=tree["label"], batch_size=BATCH, unet_dim=(12, 12), n_classes=11,
              seed=SEED, to_fit=to_fit)
    ds, jds = cg.HybridChipDataset(sources(cg), **kw), jcg.HybridChipDataset(sources(jcg), **kw)
    for got, want in zip(list(ds), list(jds)):
        (unet, series), (junet, jseries) = (got, want) if not to_fit else (got[0], want[0])
        assert unet.shape == (BATCH, 12, 12, 6)
        assert series.shape == (BATCH, 6, 8, 8, 6 if with_s1 else 4)
        _equal(unet, junet, atol=1e-6 if to_fit else 0.0)
        _equal(series, jseries, atol=1e-6 if to_fit else 0.0)
        if with_s1:  # the S1 bands are not recoloured: equal exactly
            _equal(series[..., 4:], np.asarray(jseries)[..., 4:])
        if to_fit:
            _equal(got[1], want[1])
    assert jax_draws.calls == {"color": 2 * len(ds) if to_fit else 0, "morph": 0}
