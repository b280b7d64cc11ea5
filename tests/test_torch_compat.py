"""The port's reference-name veneer (``compat.py``) against the JAX
package's, on the CPU:

- every name of tests/test_compat.py::test_every_reference_symbol_resolves,
  and every public name of the JAX ``compat``, resolves in the port's;
- ``predict_chips`` (the engine with ``blend="sum"`` on the reference's
  grid) equals JAX's ``predict_chips`` and the per-chip loop of
  ``ops.chips`` on the same scene, and keeps one engine per model and
  geometry in its LRU;
- ``get_blob_model`` dispatches ``.h5`` URLs (``file://``) to the five
  loaders by ``family`` and loads what JAX's loads; a msgpack URL goes to
  ``load_remote_weights``; ``predict_chunk`` runs a model restored that way;
- the builders need the input's channels and build the JAX models' trees;
  the NumPy twins keep the reference's NaN-aware flavor, as JAX's do.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu import compat as jcompat
from satellite_computervision_tpu_torch import compat
from satellite_computervision_tpu_torch.models import torch_to_flax
from satellite_computervision_tpu_torch.ops import chips as tchips
from test_torch_deeplab import two_torch_threads  # noqa: F401
from test_torch_keras import FAMILIES, _assert_states, _assert_trees, _bridged, _jax_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_symbols():
    """The ``symbols`` list of tests/test_compat.py's resolve test."""
    tree = ast.parse((ROOT / "tests" / "test_compat.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "symbols":
            return ast.literal_eval(node.value)
    raise AssertionError("no symbols list in tests/test_compat.py")


def test_every_reference_symbol_resolves():
    symbols = _reference_symbols()
    assert len(symbols) > 100
    missing = [s for s in symbols if not hasattr(compat, s)]
    assert not missing, f"missing compat symbols: {missing}"
    public = {n for n in dir(jcompat) if not n.startswith("_")} - {"annotations", "jnp"}
    assert sorted(public - set(dir(compat))) == []


def test_predict_chips_matches_jax_and_the_chip_loop(rng):
    k, b = 64, 32
    scene = rng.normal(size=(320, 288, 2)).astype(np.float32)
    template = np.zeros((320, 288, 1), np.float32)

    def m(chips):
        return chips.mean(-1, keepdim=True) * 2.0 + 1.0

    got = compat.predict_chips(scene, None, template, m, kernel=k, buff=b,
                               device="cpu").numpy()
    want = np.asarray(jcompat.predict_chips(
        scene, None, template, lambda c: c.mean(-1, keepdims=True) * 2.0 + 1.0, kernel=k,
        buff=b))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    idx = tchips.generate_chip_indices(320, 288, kernel=k, buffer=b, mode="reference")
    loop = tchips.stitch_chips(m(tchips.extract_chips(scene, idx, k, b)), idx, (320, 288, 1),
                               k, b, blend="sum").numpy()
    np.testing.assert_allclose(got, loop, rtol=0, atol=1e-6)
    assert (got != 0).any() and (got[:16] == 0).all()

    compat._PREDICT_ENGINES.clear()
    compat.predict_chips(scene, None, template, m, kernel=k, buff=b, device="cpu")
    engine = next(iter(compat._PREDICT_ENGINES.values()))
    compat.predict_chips(scene, None, template, m, kernel=k, buff=b, device="cpu")
    assert len(compat._PREDICT_ENGINES) == 1
    assert next(iter(compat._PREDICT_ENGINES.values())) is engine
    for i in range(compat._PREDICT_ENGINES_MAX + 2):
        compat.predict_chips(scene, None, template, lambda c: c[..., :1], kernel=k, buff=b,
                             cache_key=("model", i), device="cpu")
    assert len(compat._PREDICT_ENGINES) == compat._PREDICT_ENGINES_MAX


@pytest.mark.parametrize("family", FAMILIES)
def test_get_blob_model_dispatches_h5_by_family(family, rng, tmp_path):
    fam = FAMILIES[family]
    inputs = fam.inputs(rng)
    _, v = _jax_variables(fam, inputs, seed=12)
    path = tmp_path / f"{family}.hdf5"
    fam.jax_export(v["params"], v["batch_stats"], str(path))
    _, fresh = _jax_variables(fam, inputs, seed=13)
    want_p, want_s = jcompat.get_blob_model(weights_url=path.as_uri(), target=fresh["params"],
                                            batch_stats=fresh["batch_stats"], family=family)
    model = compat.get_blob_model(weights_url=path.as_uri(), target=fam.port_model(),
                                  family=family)
    params, stats = torch_to_flax(model)
    _assert_trees(params, want_p)
    _assert_trees(stats, want_s)


def test_msgpack_blob_and_predict_chunk(rng, tmp_path):
    from flax import serialization

    fam = FAMILIES["unet"]
    _, v = _jax_variables(fam, fam.inputs(rng), seed=14)
    blob = tmp_path / "weights.msgpack"
    blob.write_bytes(serialization.to_bytes(v))
    model = compat.get_blob_model(model_url=blob.as_uri(), target=fam.port_model())
    _assert_states(model.state_dict(), _bridged(fam, v).state_dict())

    chunk = rng.normal(size=(3, 16, 16)).astype(np.float32)  # (C, H, W)
    out = compat.predict_chunk(chunk, m=lambda x: x.mean(-1, keepdim=True), device="cpu")
    want = jcompat.predict_chunk(chunk, m=lambda x: x.mean(-1, keepdims=True))
    np.testing.assert_allclose(out, want, rtol=1e-6)
    h5 = tmp_path / "unet.h5"
    fam.jax_export(v["params"], v["batch_stats"], str(h5))
    probs = compat.predict_chunk(chunk, model=fam.port_model(), weights_blob_url=h5.as_uri(),
                                 device="cpu")
    jm = fam.jax_model()
    jwant = np.squeeze(np.asarray(jm.apply(v, jnp.moveaxis(chunk, 0, -1)[None])["probs"]))
    assert probs.shape == (16, 16)
    np.testing.assert_allclose(probs, jwant, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="predict fn"):
        compat.predict_chunk(chunk, device="cpu")


def test_builders_need_channels_and_build_the_jax_trees():
    with pytest.raises(ValueError, match="channel"):
        compat.get_unet_model(3)
    with pytest.raises(TypeError):
        compat.binary_unet(bias=-1.0)
    m = compat.binary_unet(bias=-1.0, filters=(4,), factors=(2,), in_channels=3)
    out = m(torch.zeros(1, 8, 8, 3))
    assert out["probs"].shape == (1, 8, 8, 1)
    assert float(m.head.bias[0].detach()) == -1.0
    assert compat.make_siamese_unet(n_channels=4, filters=(4,), factors=(2,),
                                    class_thresh=0.7).threshold == 0.7
    x = jnp.zeros((1, 8, 8, 3))
    cases = [
        (compat.get_unet_model(4, nchannels=(8, 8, 3), filters=(4, 8), factors=(2, 2)),
         jcompat.get_unet_model(4, filters=(4, 8), factors=(2, 2)), (x,)),
        (compat.get_autoencoder(2, filters=(4,), factors=(2,), in_channels=3),
         jcompat.get_autoencoder(2, filters=(4,), factors=(2,)), (x,)),
        (compat.build_unet_layers((4,), (2,), in_channels=3),
         jcompat.build_unet_layers((4,), (2,)), (x,)),
        (compat.get_lstm_model(n_channels=2, features=4), jcompat.get_lstm_model(features=4),
         (jnp.zeros((1, 3, 8, 8, 2)),)),
        (compat.get_acnn_model(5, nfilters=4, nchannels=3, depth=2),
         jcompat.get_acnn_model(5, nfilters=4, depth=2), (x,)),
        (compat.get_hybrid_model(unet_dim=(24, 24, 3), lstm_dim=(3, 8, 8, 2), n_classes=3,
                                 filters=(4, 8), factors=(3, 2), lstm_features=4),
         jcompat.get_hybrid_model(n_classes=3, filters=(4, 8), factors=(3, 2),
                                  lstm_features=4),
         (jnp.zeros((1, 24, 24, 3)), jnp.zeros((1, 3, 8, 8, 2)))),
    ]
    for port, jmod, inputs in cases:
        shapes = jax.eval_shape(jmod.init, jax.random.key(0), *inputs)
        params, stats = torch_to_flax(port)
        assert jax.tree_util.tree_structure(params) == \
            jax.tree_util.tree_structure(shapes["params"])
        assert [a.shape for a in jax.tree_util.tree_leaves(params)] == \
            [s.shape for s in jax.tree_util.tree_leaves(shapes["params"])]
        if "batch_stats" in shapes:
            assert jax.tree_util.tree_structure(stats) == \
                jax.tree_util.tree_structure(shapes["batch_stats"])
    trunk = compat.build_acnn_layers(nfilters=4, depth=2, in_ch=3)
    assert trunk.variant == 1 and compat.build_acnn_layers2(nfilters=4, depth=2,
                                                            in_ch=3).variant == 2
    assert isinstance(compat.build_lstm_layers(in_ch=2, features=4), torch.nn.Module)


def test_numpy_twins_and_augmenters_match_jax_flavor(rng):
    x = rng.normal(size=(8, 8, 3)).astype(np.float32) * 5 + 2
    x[0, 0, 0] = np.nan
    t = torch.from_numpy(x)
    for name, kw in (("normalize_array", {}), ("normalize_array", {"moments": [(2.0, 4.0)] * 3}),
                     ("rescale_array", {})):
        got = getattr(compat, name)(t, axes=(0, 1), **kw).numpy()
        want = np.asarray(getattr(jcompat, name)(x, axes=(0, 1), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)

    gen = torch.Generator().manual_seed(0)
    out = compat.aug_array_color(gen, t)
    assert np.isfinite(out[1:].numpy()).all()  # NaN does not poison the channel means
    contra, bright = compat._augment.draw_color_params(torch.Generator().manual_seed(0), 3,
                                                       per_channel=False)
    np.testing.assert_allclose(out.numpy(), compat._augment.aug_color(
        t, contra, bright, nan_aware=True).numpy(), equal_nan=True)
    assert contra.shape == () and bright.shape == ()
    clean = torch.from_numpy(np.abs(rng.uniform(0.2, 0.8, (8, 8, 3)).astype(np.float32)))
    assert compat.aug_tensor_color(torch.Generator().manual_seed(1), clean).shape == (8, 8, 3)
    hsv = compat.augColor(torch.Generator().manual_seed(2), clean)
    np.testing.assert_allclose(hsv.numpy(), compat._augment.aug_color_hsv(
        clean, *compat._augment.draw_hsv_params(torch.Generator().manual_seed(2))).numpy())
    morphed = compat.aug_tensor_morph(torch.Generator().manual_seed(3), clean)
    assert sorted(morphed.flatten().tolist()) == sorted(clean.flatten().tolist())


def test_model_builders_construct_every_family():
    h = compat.get_hierarchical_model(5, 3, 2, acnn_dim=4, lstm_dim=(6, 8, 8, 2), nfilters=4,
                                      depth=2, lstm_features=4)
    assert h.kwargs["in_channels"] == 4 and h.kwargs["series_channels"] == 2
    ae = compat.get_lstm_autoencoder(n_channels=2, n_time=3, features=4)
    assert ae.n_time == 3
    assert compat.get_acnn_model2(5, nchannels=3, nfilters=4, depth=2).kwargs["n_blocks"] == 2
    s = compat.get_siamese_layers((4,), (2,), in_channels=4)
    assert s.kwargs["in_channels"] == 4
    assert compat.get_binary_model is compat.binary_unet
    ds = compat.get_dataset([], ["B2"], kernel_size=16)
    assert ds.kernel_size == 16 and ds.workers == 2
