"""The port's spatially sharded inference (``parallel/spatial.py``) on 4
gloo ranks against the JAX package's ``make_spatial_inference`` on a
4-device submesh of the 8-device CPU mesh, and against the port's
single-device engine: the eight cases of tests/test_spatial.py, on the
same numpy scenes with the same models (a channel mean and a 3x3 box
filter). Float32 outputs within atol 1e-5 (the max is reported); the
uint8-out case within one quantization step on under 1 % of pixels, as
the JAX test allows. Every rank returns the whole prediction, equal to
rank 0's. The hann cases stitch through ``kernels/stitch.py::hann_stitch``
with the whole grid's row weights (its plain version on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.parallel import make_mesh as jax_make_mesh
from satellite_computervision_tpu.parallel.spatial import make_spatial_inference as jax_spatial
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from torch_dist_worker import MODELS, TRANSFORMS, run_ranks

WORLD, K, B = 4, 32, 16
ATOL = 1e-5


def _jax_mean(chips):
    return chips.mean(axis=-1, keepdims=True)


def _jax_avg3(x):
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out + jnp.roll(x, (dy, dx), axis=(1, 2))
    return out[..., :1] / 9.0


JAX_MODELS = {"mean": _jax_mean, "avg3": _jax_avg3}
JAX_TRANSFORMS = {
    None: (None, None),
    "uint16": (lambda s: s.astype(jnp.float32) / 10000.0,
               lambda p: (p * 255.0).astype(jnp.uint8)),
}

# name: (case, engine options of the single-device reference, the
# engine's crop (rows/cols left out at each edge), scene shape and dtype)
CASES = {
    "matches_single_device": (dict(model="mean"), dict(batch_size=8), 0,
                              (16 * K, 3 * K + 7, 3)),
    "whole_band": (dict(model="mean", tile_mode="whole", whole_multiple=8),
                   dict(tile_mode="whole", whole_multiple=8), 0, (16 * K, 3 * K + 7, 3)),
    "whole_band_halo": (dict(model="avg3", tile_mode="whole", whole_multiple=8),
                        dict(tile_mode="whole", whole_multiple=8), 1, (4 * K, 2 * K, 2)),
    "halo_continuity": (dict(model="avg3"), dict(batch_size=4), 2, (4 * K, 2 * K, 2)),
    "hann": (dict(model="avg3", blend="hann", batch_size=8), dict(batch_size=8, blend="hann"),
             0, (16 * K + 13, 3 * K + 7, 2)),
    "hann_fused_transforms": (dict(model="mean", blend="hann", batch_size=4, transform="uint16"),
                              dict(batch_size=4, blend="hann"), 0, (8 * K + 5, 2 * K + 3, 3)),
    "banded_hann": (dict(model="avg3", blend="hann", batch_size=4, max_rows=12 * K),
                    dict(batch_size=4, blend="hann"), 0, (24 * K + 9, 2 * K, 2)),
    "banded_overwrite": (dict(model="avg3", batch_size=4, max_rows=12 * K),
                         dict(batch_size=4), 0, (24 * K + 9, 2 * K, 2)),
}


def _scene(name):
    shape = CASES[name][3]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if CASES[name][0].get("transform") == "uint16":
        return rng.integers(0, 10000, shape).astype(np.uint16)
    return rng.normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 4 gloo ranks in one spawn; each rank's outputs."""
    cases = {}
    for name, (case, _, _, _) in CASES.items():
        cases[name] = dict(case, k=K, b=B, scene=torch.from_numpy(_scene(name)))
        if "max_rows" in case:  # the same scene unbanded, for banded == unbanded
            cases[name + "/unbanded"] = {k: v for k, v in cases[name].items() if k != "max_rows"}
    return run_ranks("spatial", WORLD, {"cases": cases}, tmp_path_factory.mktemp("spatial"))


def _jax_ref(name):
    case = CASES[name][0]
    pre, post = JAX_TRANSFORMS[case.get("transform")]
    mesh = jax_make_mesh([("data", WORLD)], devices=jax.devices()[:WORLD])
    run = jax_spatial(JAX_MODELS[case["model"]], mesh, axis="data", kernel=K, buffer=B,
                      batch_size=case.get("batch_size", 16), blend=case.get("blend", "overwrite"),
                      tile_mode=case.get("tile_mode", "chips"),
                      whole_multiple=case.get("whole_multiple", 32), preprocess_fn=pre,
                      output_transform=post, max_rows=case.get("max_rows"))
    return np.asarray(run(_scene(name)))


def _engine_ref(name):
    case, opts, _, _ = CASES[name]
    pre, post = TRANSFORMS[case.get("transform")]
    engine = TiledInferenceEngine(MODELS[case["model"]], kernel=K, buffer=B, out_channels=1,
                                  preprocess_fn=pre, output_transform=post, device="cpu", **opts)
    return engine.predict_scene(_scene(name)).numpy()


def _assert_close(got, want, what, crop=0):
    if crop:
        got, want = got[crop:-crop, crop:-crop], want[crop:-crop, crop:-crop]
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        # the uint8 cast truncates: a value on an integer boundary may flip
        # by one step between two partitions of the same sums
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (what, diff.max())
        return
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= ATOL, f"{what}: max abs err {err}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_matches_jax_and_engine(ranks, name):
    got = ranks[0][name].numpy()
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r][name].numpy(), got)
    scene = _scene(name)
    assert got.shape == scene.shape[:2] + (1,)
    if CASES[name][0].get("transform"):
        assert got.dtype == np.uint8
    _assert_close(got, _jax_ref(name), "against JAX")
    _assert_close(got, _engine_ref(name), "against the engine", crop=CASES[name][2])
    if "max_rows" in CASES[name][0]:
        # banded == unbanded on every pixel (the same chips, halos real)
        _assert_close(got, ranks[0][name + "/unbanded"].numpy(), "banded against unbanded")
