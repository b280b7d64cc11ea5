"""The port's multi-scene paths — ``predict_scene_batch``, the pipelined
``predict_scenes`` (staging, dispatch and read-back threads) and the
staging helpers, which training's batches go through too — against the
JAX engine and the port's own single-scene path (mirrors tests/test_inference_batch.py and
tests/test_inference.py::test_engine_nodata_cull_pipelined). Toy models:
rtol 1e-5 / atol 1e-6."""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from satellite_computervision_tpu.inference import TiledInferenceEngine as JaxEngine
from satellite_computervision_tpu_torch.data.pipeline import TrainIterator, prefetch_to_device
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.staging import run_ahead, stage_to_device

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")


def _mean(chips):
    return chips.mean(-1, keepdim=True)


def _jax_mean(chips):
    return chips.mean(axis=-1, keepdims=True)


def _port(fn=_mean, **kw):
    return TiledInferenceEngine(fn, device="cpu", **kw)


def _wait_for_no_new_threads(before, seconds=10.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate() if t.ident not in before and t.is_alive()]
        if not leaked:
            return []
        time.sleep(0.05)
    return leaked


@pytest.mark.parametrize("blend", ["overwrite", "hann"])
def test_predict_scene_batch_matches_single_and_jax(rng, blend):
    scenes = rng.normal(size=(3, 160, 140, 2)).astype(np.float32)
    kw = dict(kernel=32, buffer=16, batch_size=5, out_channels=1, blend=blend)
    calls = []

    def model(chips):
        calls.append(chips.shape[0])
        return _mean(chips)

    engine = _port(model, **kw)
    batched = engine.predict_scene_batch(scenes).numpy()
    # one chip batch across the scenes: 3 x 25 chips in groups of 5
    assert calls == [5] * 15
    for i in range(3):
        np.testing.assert_allclose(batched[i], engine.predict_scene(scenes[i]).numpy(), **TOL)
    want = np.asarray(JaxEngine(_jax_mean, **kw).predict_scene_batch(scenes))
    np.testing.assert_allclose(batched, want, **TOL)


def test_predict_scene_batch_uint8_and_chipless(rng):
    scenes = rng.uniform(0, 1, (2, 96, 96, 2)).astype(np.float32)
    kw = dict(kernel=32, buffer=16, batch_size=4, out_channels=1)
    out = _port(output_transform=lambda p: (p * 255.0).to(torch.uint8),
                **kw).predict_scene_batch(scenes).numpy()
    want = np.asarray(JaxEngine(_jax_mean, output_transform=lambda p: (p * 255.0).astype(
        jnp.uint8), **kw).predict_scene_batch(scenes))
    assert out.dtype == np.uint8
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
    tiny = np.ones((2, 20, 20, 2), np.float32)
    got = _port(index_mode="reference", **kw).predict_scene_batch(tiny).numpy()
    assert got.shape == (2, 20, 20, 1) and not got.any()


@pytest.mark.parametrize("readback", [False, True])
def test_predict_scenes_keeps_order_and_matches_jax(rng, readback):
    scenes = [rng.normal(size=(96, 96, 2)).astype(np.float32) for _ in range(4)]
    for i, s in enumerate(scenes):  # a tag per scene, so order shows
        s[0, 0, 0] = float(i + 1) * 100.0
    kw = dict(kernel=32, buffer=16, batch_size=4, out_channels=1, blend="hann")
    engine = _port(**kw)
    outs = list(engine.predict_scenes(iter(scenes), prefetch=2, readback=readback))
    assert len(outs) == 4
    assert all(isinstance(o, np.ndarray if readback else torch.Tensor) for o in outs)
    jax_engine = JaxEngine(_jax_mean, **kw)
    for scene, got in zip(scenes, outs):
        got = np.asarray(got)
        np.testing.assert_array_equal(got, engine.predict_scene(scene).numpy())
        np.testing.assert_allclose(got, np.asarray(jax_engine.predict_scene(scene)), **TOL)


def test_predict_scenes_readback_propagates_errors(rng):
    def boom(chips):
        raise RuntimeError("model exploded")

    engine = _port(boom, kernel=32, buffer=16, batch_size=4, out_channels=1)
    scenes = [rng.normal(size=(96, 96, 2)).astype(np.float32)]
    with pytest.raises(RuntimeError, match="model exploded"):
        list(engine.predict_scenes(iter(scenes), readback=True))


def test_predict_scenes_staging_error_reaches_consumer(rng):
    def scenes():
        yield rng.normal(size=(96, 96, 2)).astype(np.float32)
        raise OSError("unreadable scene")

    engine = _port(kernel=32, buffer=16, batch_size=4, out_channels=1)
    got = []
    with pytest.raises(OSError, match="unreadable scene"):
        for pred in engine.predict_scenes(scenes(), readback=True):
            got.append(pred)
    assert len(got) == 1


@pytest.mark.parametrize("readback", [False, True])
def test_predict_scenes_early_abandonment_releases_threads(rng, readback):
    """Closing the output after one item stops and joins the staging (and
    read-back) threads."""
    engine = _port(kernel=32, buffer=16, batch_size=4, out_channels=1)
    scenes = [rng.normal(size=(96, 96, 2)).astype(np.float32) for _ in range(6)]
    before = {t.ident for t in threading.enumerate()}
    gen = engine.predict_scenes(iter(scenes), prefetch=2, readback=readback)
    next(gen)
    gen.close()  # abandon with 5 scenes unconsumed
    leaked = _wait_for_no_new_threads(before)
    assert not leaked, f"threads still alive after close(): {leaked}"


@pytest.mark.parametrize("readback", [False, True])
def test_predict_scenes_culled_matches_predict_scene(rng, readback):
    """Validity is computed on the staging thread; the pipelined culled
    results equal the per-scene path scene by scene, and the JAX engine."""
    scenes = []
    for _ in range(3):
        s = rng.normal(size=(192, 192, 2)).astype(np.float32) + 5.0
        s[:96, :96] = 0.0
        s[:, -40:] = 0.0
        scenes.append(s)
    scenes.append(np.zeros((192, 192, 2), np.float32))  # all nodata
    kw = dict(kernel=64, buffer=32, batch_size=4, out_channels=1, blend="hann", nodata=0.0)
    engine = _port(**kw)
    piped = [np.asarray(p) for p in engine.predict_scenes(iter(scenes), readback=readback)]
    jax_piped = [np.asarray(p) for p in JaxEngine(_jax_mean, **kw).predict_scenes(
        iter(scenes), readback=True)]
    for scene, got, want in zip(scenes, piped, jax_piped):
        np.testing.assert_array_equal(got, engine.predict_scene(scene).numpy())
        np.testing.assert_allclose(got, want, **TOL)


def test_predict_scenes_whole_mode_and_lists(rng):
    scenes = [rng.normal(size=(70, 91, 3)).astype(np.float32) for _ in range(3)]
    kw = dict(kernel=32, buffer=16, out_channels=1, tile_mode="whole", whole_multiple=8)
    engine = _port(**kw)
    got = list(engine.predict_scenes(scenes, prefetch=1, readback=True))
    for scene, out in zip(scenes, got):
        np.testing.assert_allclose(out, np.asarray(JaxEngine(_jax_mean, **kw).predict_scene(
            scene)), **TOL)


@pytest.mark.parametrize("as_dict", [False, True], ids=["array", "dict"])
def test_stage_to_device_cpu_keeps_order_tags_and_strides(rng, as_dict):
    base = rng.normal(size=(6, 40, 30, 2)).astype(np.float32)
    labels = rng.integers(0, 2, size=(6, 40, 30)).astype(np.uint8)

    def item(i):  # strided views
        return {"x": base[i, ::2], "y": labels[i, :, ::3]} if as_dict else base[i, ::2]

    items = [(item(i), f"tag{i}") for i in range(6)]
    out = list(stage_to_device(iter(items), 2, CPU))
    assert [t for _, t in out] == [f"tag{i}" for i in range(6)]
    for (host, _), (staged, _) in zip(items, out):
        if as_dict:
            assert list(staged) == ["x", "y"]
            pairs = [(host[k], staged[k]) for k in host]
        else:
            pairs = [(host, staged)]
        for arr, tensor in pairs:
            assert tensor.is_contiguous() and tensor.dtype == torch.from_numpy(arr).dtype
            np.testing.assert_array_equal(tensor.numpy(), arr)


def test_run_ahead_bounds_its_lead_and_stops_on_close():
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield i

    before = {t.ident for t in threading.enumerate()}
    it = run_ahead(source(), 2, CPU)
    assert next(it) == 0
    time.sleep(0.2)
    # one item consumed, at most 2 queued and one waiting to be queued
    assert len(produced) <= 4
    it.close()
    assert not _wait_for_no_new_threads(before)
    assert len(produced) <= 5


class _Chips:
    feature_names = ["a"]

    def __iter__(self):
        for i in range(8):
            yield {"a": np.full((4, 4), i, np.float32)}


@pytest.mark.parametrize("stream", ["TrainIterator", "prefetch_to_device"])
def test_closing_a_training_stream_stops_and_joins_its_thread(stream):
    """Training's batches go through the stager: a closed stream, its
    thread blocked on a full queue, leaves no thread behind."""
    def endless():
        while True:
            yield {"a": np.zeros((2, 4, 4), np.float32)}

    before = {t.ident for t in threading.enumerate()}
    if stream == "TrainIterator":
        it = iter(TrainIterator(_Chips(), batch_size=2, shuffle_buffer=1, prefetch=1,
                                device="cpu"))
    else:
        it = prefetch_to_device(endless(), size=1, device="cpu")
    assert next(it)["a"].shape == (2, 4, 4)
    time.sleep(0.2)  # the thread fills the queue and blocks
    it.close()
    assert not _wait_for_no_new_threads(before)
