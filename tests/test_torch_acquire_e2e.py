"""The acquisition slice as a whole, against the JAX package: seeded
Sentinel-2 items (2 per period, 96², a masked patch on each) ->
``change_pair_composite`` -> ``cloud.pc.predict_scene(blend="hann")`` with
a small Siamese U-Net (filters 8/16), the JAX model's weights carried into
the port's by ``flax_to_torch``. The JAX side runs as its own tests run it
on the CPU (tests/test_compositing.py::test_composite_feeds_predict_scene:
the XLA engine, its hann blend by quadrant adds); the port's on the CPU
through the plain version of ``hann_stitch``. Composites within rtol 1e-5
/ atol 1e-6; probabilities within atol 1e-5 in eval mode (the same
network and blend summed in another order). Then both twins
(``change_detection_end_to_end``, ``multistate_sweep``) at their default
sizes with ``--device cpu``, and ``predict_scene(mesh=..., tile_mode="whole")``
refused."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.cloud import compositing as jc
from satellite_computervision_tpu.cloud import pc as jpc
from satellite_computervision_tpu.models import SiameseUNet as JaxSiamese
from satellite_computervision_tpu_torch import change_detection_end_to_end as change_twin
from satellite_computervision_tpu_torch import multistate_sweep as sweep_twin
from satellite_computervision_tpu_torch.cloud import compositing as tc
from satellite_computervision_tpu_torch.cloud import pc as tpc
from satellite_computervision_tpu_torch.models import SiameseUNet, flax_to_torch
from test_torch_deeplab import two_torch_threads  # noqa: F401

BANDS = ("B02", "B03", "B04", "B08")
SMALL = dict(filters=(8, 16), factors=(2, 2))
GEOMETRY = dict(kernel=32, buffer=16, batch_size=4)


def _items(rng, date, side=96, n=2, farm=False):
    out = []
    offset = 1000.0 if date >= jpc.S2_HARMONIZE_CUTOFF else 0.0
    for _ in range(n):
        bands = {b: (rng.uniform(800.0, 3000.0) + offset
                     + rng.normal(0.0, 80.0, (side, side))).astype(np.float32) for b in BANDS}
        if farm:
            for b, v in zip(BANDS, (1600.0, 1700.0, 1900.0, 1500.0)):
                bands[b][30:60, 40:70] = v + offset + rng.normal(0.0, 40.0, (30, 30))
        y, x = rng.integers(0, side - 20, 2)
        for b in BANDS:  # a cloud-masked (nodata) patch
            bands[b][y : y + 20, x : x + 20] = 0.0
        out.append({"datetime": date, "bands": bands})
    return out


def _randomized(v, rng):
    v = dict(v)
    v["params"] = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.3).astype(np.float32),
        v["batch_stats"])
    return v


def test_acquire_slice_matches_jax():
    rng = np.random.default_rng(0)
    before, after = _items(rng, "2021-06-01"), _items(rng, "2022-06-01", farm=True)
    want_scene = jc.change_pair_composite(before, after, BANDS)
    scene = tc.change_pair_composite(before, after, BANDS, device="cpu")
    assert scene.shape == (96, 96, 8) and torch.isfinite(scene).all()
    np.testing.assert_allclose(scene.numpy(), want_scene, rtol=1e-5, atol=1e-6)

    jmodel = JaxSiamese(**SMALL)
    side = GEOMETRY["kernel"] + GEOMETRY["buffer"]
    zeros = jnp.zeros((1, side, side, len(BANDS)))
    v = _randomized(jax.device_get(jmodel.init(jax.random.key(0), zeros, zeros)), rng)
    nb = len(BANDS)
    want = np.asarray(jpc.predict_scene(
        want_scene, lambda c: jmodel.apply(v, c[..., :nb], c[..., nb:])["probs"],
        blend="hann", **GEOMETRY))

    model = SiameseUNet(nb, **SMALL)
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    model.eval()
    got = tpc.predict_scene(scene, lambda c: model(c[..., :nb], c[..., nb:])["probs"],
                            blend="hann", device="cpu", **GEOMETRY)
    assert got.shape == (96, 96, 1) and got.dtype == torch.float32
    assert 0.0 < want.min() and want.max() < 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_predict_scene_refuses_a_mesh():
    scene = np.zeros((64, 64, 8), np.float32)
    # under a mesh, whole mode is refused with the JAX package's message
    # (the sharded engine itself: tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="whole-band"):
        tpc.predict_scene(scene, lambda c: c[..., :1], kernel=32, buffer=16, mesh=object(),
                          tile_mode="whole", device="cpu")
    # engine options pass through; whole mode needs no chips
    out = tpc.predict_scene(scene + 1.0, lambda c: c.mean(-1, keepdim=True), kernel=32,
                            buffer=16, tile_mode="whole", whole_multiple=8, device="cpu")
    assert out.shape == (64, 64, 1) and torch.all(out == 1.0)


def test_change_twin_default_sizes(tmp_path):
    report = change_twin.main(["--device", "cpu", "--outdir", str(tmp_path)])
    assert report["mean_prob_change"] > report["mean_prob_background"]
    assert (tmp_path / "change.tif").exists()


def test_multistate_twin_default_sizes():
    report = sweep_twin.main(["--device", "cpu"])
    assert list(report) == sweep_twin.STATES
    assert min(s["mean_iou"] for s in report.values()) > 0.7
