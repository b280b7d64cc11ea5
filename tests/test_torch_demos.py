"""The port's twins of the three short demos in ``examples/``
(change_detection, landcover_multiclass, timeseries_forecast) against the
JAX scripts on the CPU:

- each demo's batch maker bit-equal to the JAX script's on the same
  ``np.random.default_rng`` stream (the landcover batches and the rotated,
  split timeseries batches as the JAX ``main`` itself feeds them to its
  trainer, captured there), and ``apply_morph`` equal to JAX's on a batch
  for every flip and rotation;
- each demo's training steps from bridged weights agree with JAX's: the
  losses of three steps within 1e-5 relative, the change demo's with the
  same explicit morph draws passed to both. Plain SGD at the scripts'
  learning rates in both packages for their Adam, as
  tests/test_torch_convergence.py steps and for the reason it gives (Adam
  turns the rounding noise in a zero gradient into steps of the learning
  rate, which the third step's loss shows);
- each demo's flags are the JAX script's plus ``--device``, and its
  ``main`` trains and passes its own check on the CPU.
"""

import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from satellite_computervision_tpu.models import SiameseUNet as JaxSiamese
from satellite_computervision_tpu.models import losses as jlosses
from satellite_computervision_tpu.ops.augment import apply_morph as jax_apply_morph
from satellite_computervision_tpu.train import Trainer as JaxTrainer
from satellite_computervision_tpu.train.trainer import make_train_step as jax_make_train_step
from satellite_computervision_tpu_torch import change_detection as change_twin
from satellite_computervision_tpu_torch import landcover_multiclass as lc_twin
from satellite_computervision_tpu_torch import timeseries_forecast as ts_twin
from satellite_computervision_tpu_torch.data.chip_generators import (
    rearrange_timeseries,
    split_timeseries,
)
from satellite_computervision_tpu_torch.models import (
    LSTMModel,
    SiameseUNet,
    UNet,
    flax_to_torch,
    losses,
)
from satellite_computervision_tpu_torch.ops.augment import apply_morph
from satellite_computervision_tpu_torch.train.trainer import (
    Trainer,
    create_train_state,
    make_train_step,
)
from test_torch_convergence import load_example
from test_torch_convergence_families import jitted_init
from test_torch_deeplab import two_torch_threads  # noqa: F401

DEMOS = {"change_detection": change_twin, "landcover_multiclass": lc_twin,
         "timeseries_forecast": ts_twin}
MORPHS = [(True, False, 1), (False, True, 3), (True, True, 2)]


@pytest.fixture(scope="module")
def jx():
    return types.SimpleNamespace(**{n: load_example(n) for n in DEMOS})


class _Stop(Exception):
    pass


def _bridged(model, variables):
    model.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"], model))
    return model


def sgd_state(model, lr):
    return create_train_state(model, optimizer=torch.optim.SGD(model.parameters(), lr=lr))


def jax_sgd(state, lr):
    tx = optax.sgd(lr)
    return state.replace(tx=tx, opt_state=tx.init(state.params))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# ------------------------------------------------------------- change


@pytest.mark.parametrize("seed,b", [(0, 8), (3, 1), (7, 5)])
def test_change_batches_are_bit_equal(jx, seed, b):
    got = change_twin.make_batch(np.random.default_rng(seed), b)
    want = jx.change_detection.make_batch(np.random.default_rng(seed), b)
    for g, w in zip(got, want):
        _assert_equal(g, w)


@pytest.mark.parametrize("n_rot", range(4))
def test_apply_morph_on_a_batch_matches_jax(n_rot):
    x = np.random.default_rng(n_rot).random((3, 6, 6, 2)).astype(np.float32)
    for fv in (False, True):
        for fh in (False, True):
            want = np.asarray(jax_apply_morph(x, fv, fh, n_rot))
            _assert_equal(apply_morph(torch.from_numpy(x), fv, fh, n_rot).numpy(), want)


def test_change_steps_match_jax(jx):
    """The script's init (its first draw of ``make_batch(rng, 1)``), then
    three train steps with the morphs of ``MORPHS``: the JAX step as the
    script writes it, the port's ``make_step``."""
    jd = jx.change_detection
    jmodel = jitted_init(JaxSiamese)(filters=(8, 16), factors=(2, 2))
    rng = np.random.default_rng(0)
    b0, a0, _ = jd.make_batch(rng, 1)
    variables = _host(jmodel.init(jax.random.key(0), jnp.asarray(b0), jnp.asarray(a0)))
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = optax.sgd(1e-3)  # the script's learning rate
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, batch_stats, opt_state, before, after, label, fv, fh, rot):
        before, after, label = (jax_apply_morph(x, fv, fh, rot) for x in (before, after, label))

        def loss_fn(p):
            out, mutated = jmodel.apply({"params": p, "batch_stats": batch_stats}, before, after,
                                        train=True, mutable=["batch_stats"])
            loss = jlosses.weighted_bce(label, out["logits"], pos_weight=5.0, logits=True)
            return loss, mutated["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, loss

    model = _bridged(SiameseUNet(4, filters=(8, 16), factors=(2, 2)), variables)
    state = sgd_state(model, 1e-3)
    step = change_twin.make_step()
    rng_port = np.random.default_rng(0)
    change_twin.make_batch(rng_port, 1)
    for morph in MORPHS:
        batch = jd.make_batch(rng)
        for g, w in zip(change_twin.make_batch(rng_port), batch):
            _assert_equal(g, w)
        params, batch_stats, opt_state, want = jax_step(
            params, batch_stats, opt_state, *map(jnp.asarray, batch), *morph)
        got = step(state, *map(torch.from_numpy, batch), morph)["loss"]
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ----------------------------------------------------------- landcover


def test_landcover_batches_and_steps_match_jax(jx, monkeypatch):
    """The JAX ``main``'s own trainer, captured: its initial state, loss and
    first three batches. The port's ``make_batch`` on the same streams gives
    those batches bit for bit; the JAX ``Trainer``'s steps and the port's from
    the bridged state give losses within 1e-5 relative."""
    got = {"batches": []}

    class Capture:
        def __init__(self, state, loss_fn, **kwargs):
            got.update(variables=_host({"params": state.params,
                                        "batch_stats": state.batch_stats}),
                       state=state, loss_fn=loss_fn, kwargs=kwargs)
            self.state = state

        def train_step(self, state, batch, key):
            got["batches"].append(_host(batch))
            if len(got["batches"]) == 3:
                raise _Stop
            return state, {"loss": jnp.zeros(())}

    monkeypatch.setattr(jx.landcover_multiclass, "Trainer", Capture)
    monkeypatch.setattr(jx.landcover_multiclass, "UNet", jitted_init(
        jx.landcover_multiclass.UNet))
    monkeypatch.setattr(sys, "argv", ["landcover_multiclass.py"])
    with pytest.raises(_Stop):
        jx.landcover_multiclass.main()
    assert got["kwargs"] == {"pred_key": "probs", "num_classes": 4}

    rng, sigs = np.random.default_rng(0), lc_twin.signatures()
    for want in got["batches"]:
        for g, w in zip(lc_twin.make_batch(rng, sigs), want):
            _assert_equal(g, w)

    jtrainer = JaxTrainer(jax_sgd(got["state"], 2e-3), got["loss_fn"], **got["kwargs"])
    model = _bridged(UNet(5, n_classes=4, filters=(8, 16), factors=(2, 2), head="softmax"),
                     got["variables"])
    trainer = Trainer(sgd_state(model, 2e-3), lambda y, p: losses.gen_dice(y, p),
                      pred_key="probs", num_classes=4)
    for i, (x, y) in enumerate(got["batches"]):
        jtrainer.state, want = jtrainer.train_step(jtrainer.state, (x, y), jax.random.key(i))
        out = trainer.train_step(trainer.state, (torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(float(out["loss"]), float(want["loss"]), rtol=1e-5)


# ---------------------------------------------------------- timeseries


def test_timeseries_batches_and_steps_match_jax(jx, monkeypatch):
    """The JAX ``main``'s own train step, captured: its state and first
    three rotated, split batches, which the port's ``make_series_batch``,
    ``rearrange_timeseries`` and ``split_timeseries`` give bit for bit on the
    same stream; the JAX step and the port's from bridged weights give
    losses within 1e-5 relative."""
    jt = jx.timeseries_forecast
    got = {"batches": []}

    def capture_step(loss_fn, **kwargs):
        got.update(loss_fn=loss_fn, kwargs=kwargs)

        def step(state, batch, key):
            if "variables" not in got:
                got.update(variables=_host({"params": state.params,
                                            "batch_stats": state.batch_stats}), state=state)
            got["batches"].append(_host(batch))
            if len(got["batches"]) == 3:
                raise _Stop
            return state, {"loss": jnp.zeros(())}

        return step

    monkeypatch.setattr(jt, "make_train_step", capture_step)
    monkeypatch.setattr(jt, "LSTMModel", jitted_init(jt.LSTMModel))
    monkeypatch.setattr(sys, "argv", ["timeseries_forecast.py"])
    with pytest.raises(_Stop):
        jt.main()
    assert got["kwargs"] == {"pred_key": "continuous", "num_classes": 2}

    rng = np.random.default_rng(0)
    for want in got["batches"]:
        rotated, _ = rearrange_timeseries(ts_twin.make_series_batch(rng), rng)
        for g, w in zip(split_timeseries(rotated, ts_twin.C), want):
            _assert_equal(g, w)

    jstep = jax_make_train_step(got["loss_fn"], **got["kwargs"])
    jstate = jax_sgd(got["state"], 2e-3)
    model = _bridged(LSTMModel(3, 3, features=8), got["variables"])
    state = sgd_state(model, 2e-3)
    step = make_train_step(losses.masked_mse, pred_key="continuous", num_classes=2)
    for i, (x, y) in enumerate(got["batches"]):
        jstate, want = jstep(jstate, (x, y), jax.random.key(i))
        out = step(state, (torch.from_numpy(np.ascontiguousarray(x)),
                           torch.from_numpy(np.ascontiguousarray(y))))
        np.testing.assert_allclose(float(out["loss"]), float(want["loss"]), rtol=1e-5)


# ------------------------------------------------------- flags and mains


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_flags_are_the_jax_scripts_plus_device(jx, monkeypatch, name):
    from test_torch_convergence import _flags

    monkeypatch.setattr(sys, "argv", [name])
    want = _flags(lambda argv: getattr(jx, name).main(), monkeypatch)
    got = _flags(DEMOS[name].main, monkeypatch)
    assert got.pop("device") == "cuda"
    assert got == want == {"steps": {"change_detection": 60, "landcover_multiclass": 240,
                                     "timeseries_forecast": 300}[name]}


@pytest.mark.parametrize("name,steps", [("landcover_multiclass", "120"),
                                        ("timeseries_forecast", "200")])
def test_demo_runs_on_the_cpu(name, steps, capsys):
    """``main`` on the CPU at fewer steps than its default, enough for its
    own check to pass (the change demo runs at its default in
    tests/test_torch_chip_smoke.py)."""
    DEMOS[name].main(["--steps", steps, "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == "OK"
