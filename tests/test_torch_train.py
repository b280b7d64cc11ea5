"""The port's training side against the JAX package's: losses
(models/losses.py) and metrics (models/metrics.py) at rtol 1e-5 / atol
1e-6; one float32 train step of the U-Net from bridged weights (loss at
rtol 1e-5; every parameter gradient against jax.grad at rtol 1e-4 / atol
1e-6, the same math summed in another order; the updated BatchNorm
running statistics at rtol 1e-5, which pins the biased variance and the
momentum mapping); a 20-step Adam trajectory within rtol 1e-3, in the
manner of tests/test_tf_parity.py:179; and Trainer.fit with the
checkpoint manager."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models import losses as jlosses
from satellite_computervision_tpu.models import metrics as jmetrics
from satellite_computervision_tpu.train import Trainer as JaxTrainer
from satellite_computervision_tpu.train import create_train_state as jax_create_train_state
from satellite_computervision_tpu.train.trainer import make_train_step as jax_make_train_step
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch, losses, metrics
from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint
from satellite_computervision_tpu_torch.train.trainer import (
    Trainer,
    create_train_state,
    make_train_step,
)
from test_torch_deeplab import two_torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **(tol or TOL))


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("logits", [True, False])
@pytest.mark.parametrize("pos_weight", [1.0, 20.0])
def test_weighted_bce_matches_jax(rng, logits, pos_weight):
    y = (rng.uniform(size=(2, 8, 8, 1)) > 0.7).astype(np.float32)
    p = rng.normal(0, 4, (2, 8, 8, 1)).astype(np.float32)
    if not logits:
        p = 1.0 / (1.0 + np.exp(-p))
    p[0, 0, 0, 0] = 60.0 if logits else 1.0  # the stable identity's far tail / the clip
    _close(losses.weighted_bce(_t(y), _t(p), pos_weight, logits),
           jlosses.weighted_bce(y, p, pos_weight, logits))


def _onehot(rng, shape, c):
    lab = rng.integers(0, c - 1, shape)  # class c-1 absent: its weight is eps
    return np.eye(c, dtype=np.float32)[lab]


@pytest.mark.parametrize("kw", [dict(), dict(batch_counts=False),
                                dict(global_weights=[0.2, 1.0, 3.0])], ids=str)
def test_gen_dice_matches_jax(rng, kw):
    y = _onehot(rng, (3, 8, 8), 3)
    p = rng.dirichlet(np.ones(3), (3, 8, 8)).astype(np.float32)
    _close(losses.gen_dice(_t(y), _t(p), **kw), jlosses.gen_dice(y, p, **kw))


def test_gen_dice_ref_compat_matches_jax(rng):
    y = (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    p = rng.uniform(size=(2, 8, 8, 1)).astype(np.float32)
    _close(losses.gen_dice(_t(y), _t(p), ref_compat=True),
           jlosses.gen_dice(y, p, ref_compat=True))


@pytest.mark.parametrize("reduce_mean", [True, False])
def test_wcce_and_iou_match_jax(rng, reduce_mean):
    y = _onehot(rng, (2, 8, 8), 4)
    p = rng.uniform(0.0, 1.0, (2, 8, 8, 4)).astype(np.float32)
    w = np.array([1.0, 2.0, 0.5, 4.0], np.float32)
    _close(losses.weighted_categorical_crossentropy(_t(y), _t(p), w, reduce_mean=reduce_mean),
           jlosses.weighted_categorical_crossentropy(y, p, w, reduce_mean=reduce_mean))
    _close(losses.iou_loss(_t(y), _t(p)), jlosses.iou_loss(y, p))


def test_masked_mse_value_and_finite_gradient(rng):
    y = rng.normal(size=(2, 4, 4, 1)).astype(np.float32)
    y[0, 1, :, 0] = np.nan
    y[1, 0, 0, 0] = np.inf
    p = rng.normal(size=y.shape).astype(np.float32)
    pred = _t(p).requires_grad_(True)
    loss = losses.masked_mse(_t(y), pred)
    loss.backward()
    _close(loss, jlosses.masked_mse(y, p))
    assert torch.isfinite(pred.grad).all()
    _close(pred.grad, jax.grad(lambda q: jlosses.masked_mse(y, q))(p))


def test_make_loss_table(rng):
    y = (rng.uniform(size=(2, 4, 4, 1)) > 0.5).astype(np.float32)
    p = rng.uniform(0.05, 0.95, (2, 4, 4, 1)).astype(np.float32)
    for name, kw in [("weighted_bce", {"pos_weight": 2.0}), ("gen_dice", {}),
                     ("weighted_categorical_crossentropy", {"weights": [1.0]}),
                     ("iou", {}), ("masked_mse", {})]:
        _close(losses.make_loss(name, **kw)(_t(y), _t(p)), jlosses.make_loss(name, **kw)(y, p))
    with pytest.raises(KeyError):
        losses.make_loss("nope")


# ----------------------------------------------------------------- metrics


def test_metrics_match_jax(rng):
    y = rng.integers(0, 3, (4, 8, 8))
    p = rng.integers(0, 3, (4, 8, 8))
    p[y == 2] = 0  # class 2 is never predicted
    cm = metrics.confusion_matrix(_t(y), _t(p), 4)  # class 3 absent from both
    jcm = jmetrics.confusion_matrix(y, p, 4)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    for fn, jfn in [(metrics.mean_iou_from_cm, jmetrics.mean_iou_from_cm),
                    (metrics.accuracy_from_cm, jmetrics.accuracy_from_cm),
                    (metrics.f1_from_cm, jmetrics.f1_from_cm),
                    (metrics.normalize_confusion_matrix, jmetrics.normalize_confusion_matrix)]:
        _close(fn(cm), jfn(jcm))
    state = metrics.update_metric_state(metrics.init_metric_state(4), _t(y), _t(p))
    jstate = jmetrics.update_metric_state(jmetrics.init_metric_state(4), y, p)
    for k, v in jmetrics.finalize_metrics(jstate).items():
        _close(metrics.finalize_metrics(state)[k], v)


# ------------------------------------------------------------ train step

BANDS, SIDE = 4, 16


def _models(s2d, bn_momentum, rng):
    kw = dict(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid", threshold=0.9,
              bn_momentum=bn_momentum, space_to_depth=s2d)
    jmodel = JaxUNet(**kw)
    v = jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((1, SIDE, SIDE, BANDS))))
    # running statistics away from (0, 1), so the update's both terms show
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.5).astype(np.float32),
        v["batch_stats"])
    model = UNet(BANDS, **kw)
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    return jmodel, v, model


def _batch(rng, b=4):
    x = rng.normal(size=(b, SIDE, SIDE, BANDS)).astype(np.float32)
    y = (x[..., :1] + 0.3 * x[..., 1:2] > 0.4).astype(np.float32)
    return x, y


@pytest.mark.parametrize("bn_momentum", [0.99, 0.9])
@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
def test_one_train_step_matches_jax(rng, s2d, bn_momentum):
    jmodel, v, model = _models(s2d, bn_momentum, rng)
    x, y = _batch(rng)

    def jloss(params):
        out, mutated = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                    train=True, mutable=["batch_stats"])
        return jlosses.weighted_bce(y, out["logits"], 2.0, logits=True), mutated["batch_stats"]

    (want_loss, want_stats), want_grads = jax.value_and_grad(jloss, has_aux=True)(v["params"])

    model.train()
    loss = losses.weighted_bce(_t(y), model(_t(x))["logits"], 2.0, logits=True)
    loss.backward()
    _close(loss, want_loss, rtol=1e-5)

    grads = flax_to_torch(jax.device_get(want_grads), v["batch_stats"], model)
    for name, p in model.named_parameters():
        _close(p.grad, grads[name], rtol=1e-4, atol=1e-6)
    stats = flax_to_torch(v["params"], jax.device_get(want_stats), model)
    n_bn = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _close(buf, stats[name], rtol=1e-5)
            n_bn += 1
    assert n_bn == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_adam_trajectory_matches_jax(rng):
    """20 Adam steps (lr 9e-4, optax defaults) from bridged weights on the
    same batches: per-step losses within rtol 1e-3."""
    jmodel, v, model = _models(True, 0.9, rng)
    batches = [_batch(rng) for _ in range(5)]
    jloss_fn = lambda y, p: jlosses.weighted_bce(y, p, pos_weight=2.0, logits=True)  # noqa: E731
    jstate = jax_create_train_state(jmodel, jax.random.key(0),
                                    jnp.zeros((1, SIDE, SIDE, BANDS)), tx=optax.adam(9e-4))
    jstate = jstate.replace(params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=optax.adam(9e-4).init(v["params"]))
    jstep = jax_make_train_step(jloss_fn, donate=False)
    state = create_train_state(model, 9e-4)
    step = make_train_step(lambda y, p: losses.weighted_bce(y, p, 2.0, logits=True))
    want, got = [], []
    for i in range(20):
        x, y = batches[i % len(batches)]
        jstate, jout = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        want.append(float(jout["loss"]))
        out = step(state, (_t(x), _t(y)))
        got.append(float(out["loss"]))
        np.testing.assert_array_equal(out["cm"].numpy(), np.asarray(jout["cm"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0] and state.step == 20


# ---------------------------------------------------------- Trainer.fit


class _CountingManager(CheckpointManager):
    def __init__(self, root):
        super().__init__(root)
        self.saves = []

    def save(self, state, step, metrics=None):
        self.saves.append((step, dict(metrics)))
        super().save(state, step, metrics)


def _toy(seed):
    torch.manual_seed(seed)
    return UNet(2, n_classes=1, filters=(4,), factors=(2,), head="sigmoid")


def _toy_batches(rng, n):
    out = []
    for _ in range(n):
        x = rng.normal(size=(4, 16, 16, 2)).astype(np.float32)
        out.append((x, (x[..., :1] > 0.5).astype(np.float32)))
    return out


def test_trainer_fit_checkpoints_only_on_improvement_and_resumes(tmp_path, rng):
    loss_fn = lambda y, p: losses.weighted_bce(y, p, pos_weight=1.0, logits=True)  # noqa: E731
    train = [(_t(x), _t(y)) for x, y in _toy_batches(rng, 3)]
    evalb = [(_t(x), _t(y)) for x, y in _toy_batches(rng, 2)]
    ckpt = _CountingManager(str(tmp_path / "ckpt"))
    trainer = Trainer(create_train_state(_toy(0), 1e-2), loss_fn, checkpoint_manager=ckpt)

    def forever():
        while True:
            yield from train

    history = trainer.fit(forever(), epochs=5, steps_per_epoch=2, eval_fn=lambda: evalb,
                          log_fn=lambda r: None)
    vals = [r["val"]["mean_iou"] for r in history]
    improved = [i for i, v in enumerate(vals) if v > max(vals[:i], default=float("-inf"))]
    assert [i for i, r in enumerate(history) if r.get("checkpointed")] == improved
    assert [s for s, _ in ckpt.saves] == [2 * (i + 1) for i in improved]
    assert ckpt.best_metrics() == history[improved[-1]]["val"]
    assert trainer.best == max(vals) and trainer.state.step == 10

    # history keys as the JAX Trainer writes them
    jmodel = JaxUNet(n_classes=1, filters=(4,), factors=(2,), head="sigmoid")
    jstate = jax_create_train_state(jmodel, jax.random.key(0), jnp.zeros((1, 16, 16, 2)),
                                    tx=optax.adam(1e-2))
    jtrain = [(jnp.asarray(x), jnp.asarray(y)) for x, y in _toy_batches(rng, 1)]
    jhist = JaxTrainer(jstate, loss_fn=lambda y, p: jlosses.weighted_bce(y, p, 1.0, logits=True)
                       ).fit(iter(jtrain * 2), epochs=1, steps_per_epoch=2,
                             eval_fn=lambda: jtrain, log_fn=lambda r: None)
    assert sorted(history[0]) == sorted(jhist[0])
    assert sorted(history[0]["train"]) == sorted(jhist[0]["train"])
    assert sorted(history[0]["val"]) == sorted(jhist[0]["val"])

    # resume: the best weights, optimizer state and step come back, and an
    # evaluation re-seeds the best metric
    best_model, meta = load_checkpoint(str(tmp_path / "ckpt"))
    fresh = Trainer(create_train_state(_toy(1), 1e-2), loss_fn, checkpoint_manager=ckpt)
    state, meta2 = ckpt.restore(fresh.state)
    assert meta2 == meta and state.step == 2 * (improved[-1] + 1)
    for (k, a), b in zip(state.model.state_dict().items(), best_model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert len(state.optimizer.state) == len(list(state.model.parameters()))
    result = fresh.seed_best_from_eval(evalb)
    assert fresh.best == result["mean_iou"]
    assert result["mean_iou"] == pytest.approx(meta["metrics"]["mean_iou"], rel=1e-6)
    assert (tmp_path / "ckpt" / "latest" / "model.pt").exists()


@pytest.mark.parametrize("keep_latest", [True, False])
def test_checkpoint_manager_keep_latest_and_save_latest_match_jax(tmp_path, rng, keep_latest):
    """``CheckpointManager(keep_latest=...)`` and ``save_latest`` write the
    same directories and restore the same step and metrics as the JAX
    package's manager: ``save`` writes ``best`` (and ``latest`` with
    ``keep_latest``), ``save_latest`` writes ``latest`` alone."""
    from satellite_computervision_tpu.train.checkpoint import CheckpointManager as JaxManager

    jmodel = JaxUNet(n_classes=1, filters=(4,), factors=(2,), head="sigmoid")
    jstate = jax_create_train_state(jmodel, jax.random.key(0), jnp.zeros((1, 16, 16, 2)))
    state = create_train_state(_toy(0))
    managers = [JaxManager(str(tmp_path / "jax"), keep_latest=keep_latest),
                CheckpointManager(str(tmp_path / "torch"), keep_latest=keep_latest)]
    for manager, s in zip(managers, (jstate, state)):
        manager.save(s, 3, {"mean_iou": 0.5})
    want = ["best", "latest"] if keep_latest else ["best"]
    assert [sorted(os.listdir(m.root)) for m in managers] == [want, want]
    for manager, s in zip(managers, (jstate, state)):
        manager.save_latest(s, 5, {"mean_iou": 0.25})
    assert [sorted(os.listdir(m.root)) for m in managers] == [["best", "latest"]] * 2
    for manager, s in zip(managers, (jstate, state)):
        assert manager.best_metrics() == {"mean_iou": 0.5}
        for which, step, iou in (("best", 3, 0.5), ("latest", 5, 0.25)):
            _, meta = manager.restore(s, which)
            assert (meta["step"], meta["metrics"]) == (step, {"mean_iou": iou})
