"""The port's U-Net ``remat``, the train CLI's ``--remat``/``--orbax`` and
``train/retrain.py`` against the JAX package, on the CPU at small sizes.

- Remat: forward equal to the JAX ``UNet(remat=True)`` from bridged weights
  (tests/test_pipeline.py:131's model; logits at rtol 1e-5, train mode too);
  one train step with remat leaves parameters, gradients, BatchNorm
  running statistics and ``num_batches_tracked`` bit-equal to a plain
  step's, dropout masks included, with the same ``state_dict`` keys; one
  SGD step against the JAX remat model's (loss rtol 1e-5, parameters rtol
  1e-4 / atol 1e-6, running statistics rtol 1e-5 / atol 1e-8).
- The train CLI with ``--remat --orbax``: the model checkpoints through
  ``torch.distributed.checkpoint`` and restores bit-equal; ``--resume``
  reads it.
- Retrain: tests/test_aux.py:216 mirrored against JAX's ``retrain`` from a
  JAX checkpoint directory, a flax blob through a ``file://`` URL
  (``load_remote_weights``) and a port checkpoint: the seeded best metric
  at rtol 1e-5, three steps with ``freeze_to="head"`` (the head within
  rtol 1e-4 / atol 1e-6 of JAX's, every other parameter bit-unchanged,
  running statistics within rtol 1e-5 / atol 1e-8)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp
import optax

from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models import losses as jlosses
from satellite_computervision_tpu.train import save_checkpoint as jax_save_checkpoint
from satellite_computervision_tpu.train.retrain import retrain as jax_retrain
from satellite_computervision_tpu.train.trainer import TrainState as JaxTrainState
from satellite_computervision_tpu.train.trainer import make_train_step as jax_train_step
from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch, losses
from satellite_computervision_tpu_torch.train import __main__ as train_cli
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_flax_weights,
    load_remote_weights,
    save_checkpoint,
)
from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG
from satellite_computervision_tpu_torch.train.retrain import freeze_mask, retrain
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

SMALL = dict(n_classes=1, filters=(4,), factors=(2,), head="sigmoid")


def _bridged(variables, **kw):
    model = UNet(kw.pop("in_channels", 3), **{**SMALL, **kw})
    model.load_state_dict(flax_to_torch(jax.device_get(variables["params"]),
                                        jax.device_get(variables.get("batch_stats")), model))
    return model


def _jax_state(model, x, tx, seed):
    """JAX's ``create_train_state`` with the init jitted (eager flax init
    compiles op by op: seconds on the CPU)."""
    v = jax.jit(model.init)(jax.random.key(seed), x)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                         batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                         apply_fn=model.apply, tx=tx)


def _loss(y, p):
    return losses.weighted_bce(y, p, pos_weight=1.0, logits=True)


def _jax_loss(y, p):
    return jlosses.weighted_bce(y, p, pos_weight=1.0, logits=True)


# ------------------------------------------------------------------ remat


def test_remat_forward_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
    jremat = JaxUNet(**SMALL, remat=True)
    v = jax.jit(JaxUNet(**SMALL).init)(jax.random.key(1), x)
    model = _bridged(v, remat=True)
    assert model.remat and model.kwargs["remat"]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jremat.apply)(v, x)["logits"]),
                               rtol=1e-5, atol=1e-6)
    want, _ = jax.jit(lambda v, x: jremat.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    got = model.train()(torch.from_numpy(x))["logits"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want["logits"]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dropout", [None, 0.3])
def test_remat_step_equals_plain_step(dropout):
    """Bit-equal on the CPU: the same forward, the recompute replaying the
    dropout masks, and the running statistics moved once."""
    torch.manual_seed(0)
    kw = dict(SMALL, filters=(4, 8), factors=(2, 2), dropout=dropout)
    plain, remat = UNet(3, **kw), UNet(3, **kw, remat=True)
    remat.load_state_dict(plain.state_dict())
    assert list(plain.state_dict()) == list(remat.state_dict())
    x = torch.randn(2, 16, 16, 3)
    y = (x[..., :1] > 0).float()
    outs = []
    for model in (plain, remat):
        state = create_train_state(model, 1e-2)
        torch.manual_seed(7)
        outs.append(make_train_step(_loss)(state, (x, y)))
    assert torch.equal(outs[0]["loss"], outs[1]["loss"])
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), name
    for (name, a), b in zip(plain.state_dict().items(), remat.state_dict().values()):
        assert torch.equal(a, b), name  # parameters, running stats, num_batches_tracked
    assert int(remat.EncoderBlock_0.ConvBlock_0.ConvBNAct_0.BatchNorm_0.num_batches_tracked) == 1


def test_remat_sgd_step_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 3)).astype(np.float32)
    y = (x[..., :1] > 0.3).astype(np.float32)
    jstate = _jax_state(JaxUNet(**SMALL, remat=True), x, optax.sgd(0.5), seed=3)
    model = _bridged({"params": jstate.params, "batch_stats": jstate.batch_stats}, remat=True)
    jnew, jout = jax_train_step(_jax_loss, pred_key="logits", donate=False)(jstate, (x, y))
    state = create_train_state(model, optimizer=torch.optim.SGD(model.parameters(), lr=0.5))
    out = make_train_step(_loss)(state, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-5)
    want = flax_to_torch(jax.device_get(jnew.params), jax.device_get(jnew.batch_stats),
                         UNet(3, **SMALL))
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 1
        elif "running" in key:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-8,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(value.detach().numpy(), want[key].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_remat_in_checkpoints(tmp_path):
    """``remat`` is saved with the model; a file written before the key
    existed loads without it."""
    model = UNet(3, **SMALL, remat=True)
    save_checkpoint(str(tmp_path / "a"), model)
    loaded, _ = load_checkpoint(str(tmp_path / "a"))
    assert loaded.remat and list(loaded.state_dict()) == list(model.state_dict())
    blob = torch.load(tmp_path / "a" / "best" / "model.pt", weights_only=True)
    del blob["model_kwargs"]["remat"]
    os.makedirs(tmp_path / "old" / "best")
    torch.save(blob, tmp_path / "old" / "best" / "model.pt")
    old, _ = load_checkpoint(str(tmp_path / "old"))
    assert not old.remat
    for (k, a), b in zip(model.state_dict().items(), old.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_cli_remat_orbax(tmp_path, monkeypatch):
    k = 32
    small = dataclasses.replace(SOLAR_CONFIG, kernel_size=k, kernel_buffer=16, batch_size=4)
    monkeypatch.setitem(train_cli.CONFIGS, "solar", small)
    fam = zoo.FAMILIES["unet"]
    monkeypatch.setitem(zoo.FAMILIES, "unet", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, filters=(4, 8), factors=(2, 2), **kw)))
    rng = np.random.default_rng(0)
    examples = []
    for _ in range(8):
        ex = {b: rng.uniform(0, 0.3, k * k).astype(np.float32) for b in small.bands}
        ex[small.response] = (rng.uniform(size=k * k) > 0.7).astype(np.float32)
        examples.append(ex)
    chips = str(tmp_path / "train.tfrecord.gz")
    write_tfrecord_file(chips, examples)
    ckpt = str(tmp_path / "run")
    args = ["--config", "solar", "--model", "unet", "--train", chips, "--eval", chips,
            "--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "4",
            "--remat", "--orbax", "--device", "cpu"]
    trainer = train_cli.main(args)
    model = trainer.state.model
    assert model.remat and trainer.state.step == 2
    files = os.listdir(os.path.join(ckpt, "best"))
    assert ".metadata" in files and "scv_meta.json" in files and "model.pt" not in files
    fresh = create_train_state(fam.build(small, filters=(4, 8), factors=(2, 2),
                                         bn_momentum=0.9, remat=True), 9e-4)
    _, meta = CheckpointManager(ckpt, backend="dcp").restore(fresh, "best")
    assert meta["step"] == 2 and fresh.step == 2
    for (key, a), b in zip(model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), key
    resumed = train_cli.main(args + ["--resume"])
    assert resumed.state.step == 4  # restored at 2, then 2 more steps


# ------------------------------------------------------------------ retrain


def test_freeze_mask():
    model = UNet(3, **SMALL)
    mask = freeze_mask(model, {"head"})
    assert set(mask) == {n for n, _ in model.named_parameters()}
    assert all(frozen == (not name.startswith("head.")) for name, frozen in mask.items())
    assert not any(freeze_mask(model, {"head", "EncoderBlock_0", "ConvBlock_0",
                                       "DecoderBlock_0"}).values())


@pytest.fixture(scope="module")
def jax_retrained(tmp_path_factory):
    """tests/test_aux.py:216 on the JAX side: a checkpoint, retrain with a
    fresh lr and the head alone trainable, three steps."""
    work = tmp_path_factory.mktemp("retrain")
    state = _jax_state(JaxUNet(**SMALL), np.zeros((1, 16, 16, 2), np.float32),
                       optax.adam(1e-2), seed=0)
    jax_save_checkpoint(str(work / "c"), state, {"mean_iou": 0.4}, step=5)
    with open(work / "params.msgpack", "wb") as f:
        f.write(flax.serialization.to_bytes(jax.device_get(state.params)))
    rng = np.random.default_rng(42)
    x = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    y = (x[..., :1] > 0).astype(np.float32)
    trainer = jax_retrain(state, _jax_loss, checkpoint_path=str(work / "c"), eval_iter=[(x, y)],
                          learning_rate=1e-3, freeze_to="head")
    best = trainer.best
    for _ in range(3):
        trainer.state, _ = trainer.train_step(trainer.state, (x, y), jax.random.key(1))
    return work, state, (x, y), best, trainer.state


@pytest.mark.parametrize("source", ["jax_checkpoint", "file_url", "port_checkpoint"])
def test_retrain_matches_jax(jax_retrained, tmp_path, source):
    work, init, (x, y), jax_best, jax_after = jax_retrained
    # the port's model starts from other weights: the source brings JAX's
    model = UNet(2, **SMALL)
    state = create_train_state(model, 1e-2)
    kw = {}
    if source == "jax_checkpoint":
        kw["checkpoint_path"] = str(work / "c")
    elif source == "file_url":
        kw["weights_url"] = (work / "params.msgpack").as_uri()
    else:
        donor = load_flax_weights(UNet(2, **SMALL), jax.device_get(
            {"params": init.params, "batch_stats": init.batch_stats}))
        save_checkpoint(str(tmp_path), donor, {"mean_iou": 0.4}, step=5)
        kw["checkpoint_path"] = str(tmp_path / "best")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    trainer = retrain(state, _loss, eval_iter=[(xt, yt)], learning_rate=1e-3, freeze_to="head",
                      **kw)
    np.testing.assert_allclose(trainer.best, jax_best, rtol=1e-5)
    # the step of the source: JAX's restored state's, the port file's 5
    assert trainer.state.step == {"jax_checkpoint": int(jax_after.step) - 3, "file_url": 0,
                                  "port_checkpoint": 5}[source]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(3):
        trainer.train_step(trainer.state, (xt, yt))
    want = flax_to_torch(jax.device_get(jax_after.params), jax.device_get(jax_after.batch_stats),
                         UNet(2, **SMALL))
    for key, value in model.state_dict().items():
        if key.startswith("head."):
            assert not torch.equal(value, before[key]), key
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
        elif "running" in key:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-8,
                                       err_msg=key)
        elif not key.endswith("num_batches_tracked"):
            assert torch.equal(value, before[key]), key  # frozen: bit-unchanged


def test_load_remote_weights_takes_a_full_state(tmp_path):
    v = jax.jit(JaxUNet(**SMALL).init)(jax.random.key(4), np.zeros((1, 16, 16, 3), np.float32))
    v = jax.device_get({"params": v["params"],
                        "batch_stats": jax.tree_util.tree_map(lambda a: a + 0.5,
                                                              v["batch_stats"])})
    with open(tmp_path / "state.msgpack", "wb") as f:
        f.write(flax.serialization.to_bytes(v))
    got = load_remote_weights((tmp_path / "state.msgpack").as_uri(), UNet(3, **SMALL))
    want = load_flax_weights(UNet(3, **SMALL), v)
    for key, value in want.state_dict().items():
        assert torch.equal(got.state_dict()[key], value), key
