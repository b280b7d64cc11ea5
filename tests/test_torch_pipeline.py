"""The port's input side against the JAX package's: the TFRecord codec
(data/tfrecord.py, native/), the batching order (data/pipeline.py
TrainIterator) and make_preprocess_fn on both of its routes, with the JAX
function's own per-chip draws injected. Files and batches must match
exactly; preprocessed features to rtol 1e-4 / atol 1e-5 (the kernel route
sums the mean in another order, as tests/test_pallas.py allows), labels
exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.data import pipeline as jpipe
from satellite_computervision_tpu.data import tfrecord as jtfr
from satellite_computervision_tpu.ops.augment import draw_morph_params
from satellite_computervision_tpu_torch import native
from satellite_computervision_tpu_torch.data import pipeline, tfrecord

TOL = dict(rtol=1e-4, atol=1e-5)
BANDS = ["B2", "B3", "B4"]
K = 8


def _examples(rng, n, k=K, classes=2):
    out = []
    for _ in range(n):
        ex = {b: rng.uniform(0.0, 3000.0, k * k).astype(np.float32) for b in BANDS}
        ex["landcover"] = rng.integers(0, classes, k * k).astype(np.float32)
        out.append(ex)
    return out


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif native.get_lib() is None:
        pytest.skip("g++ unavailable; the native codec is not built")
    return request.param


def test_native_builds_into_the_build_dir():
    if native.get_lib() is None:
        pytest.skip("g++ unavailable; the native codec is not built")
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert native.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("compression", [None, "GZIP"])
def test_tfrecord_cross_reads_with_jax(tmp_path, rng, codec, compression):
    examples = _examples(rng, 3)
    ours, theirs = str(tmp_path / "ours.tfr"), str(tmp_path / "theirs.tfr")
    tfrecord.write_tfrecord_file(ours, examples, compression)
    jtfr.write_tfrecord_file(theirs, examples, compression)
    for path in (ours, theirs):
        for read in (tfrecord.read_tfrecord_file, jtfr.read_tfrecord_file):
            rows = read(path, compression, verify_crc=True)
            for ex, row in zip(examples, rows, strict=True):
                for name, arr in ex.items():
                    np.testing.assert_array_equal(row[name], arr)
        rows = tfrecord.read_float_examples(path, BANDS + ["landcover"], compression,
                                            verify_crc=True)
        for ex, row in zip(examples, rows, strict=True):
            for name in ex:
                np.testing.assert_array_equal(row[name], ex[name])
    if compression is None:  # identical bytes, CRCs included
        assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_crc_equal_with_and_without_native(monkeypatch, codec):
    for blob in [b"", b"123456789", bytes(range(256)) * 5]:
        assert tfrecord.crc32c(blob) == jtfr.crc32c(blob)
        assert tfrecord.masked_crc32c(blob) == jtfr.masked_crc32c(blob)


def _write(tmp_path, rng, n_files=2, per_file=5, k=K, classes=2):
    files = []
    for i in range(n_files):
        path = str(tmp_path / f"chips{i}.tfrecord.gz")
        jtfr.write_tfrecord_file(path, _examples(rng, per_file, k, classes))
        files.append(path)
    return files


@pytest.mark.parametrize("stage_dtype", [None, "float16"])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_train_iterator_matches_jax_order(tmp_path, rng, stage_dtype, drop_remainder):
    files = _write(tmp_path, rng)
    names = BANDS + ["landcover"]
    kw = dict(batch_size=3, shuffle_buffer=4, repeat=True, seed=7,
              drop_remainder=drop_remainder, stage_dtype=stage_dtype)
    theirs = jpipe.TrainIterator(jpipe.ChipDataset(files, names, K), **kw)
    ours = pipeline.TrainIterator(pipeline.ChipDataset(files, names, K), device="cpu", **kw)
    jit_, oit = iter(theirs), iter(ours)
    for _ in range(9):  # 10 chips per epoch: the repeats cross epochs
        a, b = next(jit_), next(oit)
        assert sorted(a) == sorted(b)
        for name in names:
            assert b[name].dtype == (torch.float16 if stage_dtype else torch.float32)
            np.testing.assert_array_equal(b[name].numpy(), np.asarray(a[name]))


def test_eval_dataset_single_pass_keeps_tail(tmp_path, rng):
    files = _write(tmp_path, rng, n_files=1, per_file=5)
    batches = list(pipeline.get_eval_dataset(files, BANDS, K, batch_size=2, device="cpu"))
    assert [b["B2"].shape[0] for b in batches] == [2, 2, 1]


def test_prefetch_propagates_worker_errors():
    def boom():
        yield {"a": np.zeros(2, np.float32)}
        raise OSError("disk gone")

    it = pipeline.prefetch_to_device(boom(), device="cpu")
    assert next(it)["a"].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def _jax_pipeline_draws(key, batch, n_color):
    """The draws JAX's make_preprocess_fn makes for itself: split(key, 2B);
    aug_color's (ckey, bkey) on the first key of each chip, the morph on
    the second."""
    keys = jax.random.split(key, batch * 2).reshape(batch, 2)

    def one(k2):
        ckey, bkey = jax.random.split(k2[0])
        contra = jax.random.uniform(ckey, (n_color,), minval=0.95, maxval=1.05)
        bright = jax.random.uniform(bkey, (n_color,), minval=0.95, maxval=1.05)
        fv, fh, rot = draw_morph_params(k2[1])
        return contra, bright, jnp.stack([fv.astype(jnp.int32), fh.astype(jnp.int32), rot])

    return tuple(torch.from_numpy(np.array(a)) for a in jax.vmap(one)(keys))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("axes", [(0, 1), (2,)], ids=["kernel", "plain"])
@pytest.mark.parametrize("depth", [None, 3], ids=["binary", "onehot"])
def test_make_preprocess_fn_matches_jax(rng, axes, train, depth):
    batch = {b: rng.uniform(0.0, 3000.0, (4, K, K)).astype(np.float32) for b in BANDS}
    batch["landcover"] = rng.integers(0, 3, (4, K, K)).astype(np.float32)  # 2 clips to 1
    want_x, want_y = jpipe.make_preprocess_fn(BANDS, "landcover", axes=axes,
                                              response_depth=depth)(
        batch, jax.random.key(3), train=train)
    pre = pipeline.make_preprocess_fn(BANDS, "landcover", axes=axes, response_depth=depth,
                                      device="cpu")
    assert pre.fused == (axes == (0, 1))  # the kernel route
    draws = _jax_pipeline_draws(jax.random.key(3), 4, len(BANDS)) if train else None
    x, y = pre(batch, train=train, draws=draws)
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))
    assert y.max() <= 1.0


def test_make_preprocess_fn_onehot_features_and_generator(rng):
    """A one-hot feature band rides between the bands and the response on
    both routes; augmenting draws from the generator (and needs one)."""
    batch = {b: rng.uniform(0, 1, (2, K, K)).astype(np.float32) for b in BANDS}
    batch["lc"] = rng.integers(0, 3, (2, K, K)).astype(np.float32)
    batch["landcover"] = rng.integers(0, 2, (2, K, K)).astype(np.float32)
    outs = []
    for axes in [(0, 1), (0, 1, 2)]:
        pre = pipeline.make_preprocess_fn(BANDS + ["lc"], "landcover", axes=axes,
                                          one_hot={"lc": 3}, device="cpu")
        want = jpipe.make_preprocess_fn(BANDS + ["lc"], "landcover", axes=axes,
                                        one_hot={"lc": 3})(batch, jax.random.key(0), train=False)
        x, _ = pre(batch, train=False)
        assert x.shape == (2, K, K, len(BANDS) + 3)
        np.testing.assert_allclose(x.numpy(), np.asarray(want[0]), **TOL)
        with pytest.raises(ValueError, match="generator"):
            pre(batch)
        outs.append(pre(batch, torch.Generator().manual_seed(1))[0])
    # same generator seed -> same draws on both routes; (0, 1, 2) rescales
    # globally, so only the one-hot channels (moved alike) agree
    torch.testing.assert_close(outs[0][..., 3:], outs[1][..., 3:])


def test_make_preprocess_fn_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.make_preprocess_fn(BANDS, "landcover")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.TrainIterator(pipeline.ChipDataset([], BANDS, K))
