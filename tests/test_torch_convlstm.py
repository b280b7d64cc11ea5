"""The port's ConvLSTM family (models/convlstm.py) and harmonics
(ops/harmonics.py) against the JAX package's in float32 on the CPU, at
features 4-8, 8²-12² and T 3, with seeded weights carried by
``flax_to_torch``:

- ``hard_sigmoid`` bit-equal to JAX's (Keras's ``clip(0.2 x + 0.5, 0, 1)``,
  not torch's ``F.hardsigmoid``), the harmonics within 1e-6;
- the cell and ``ConvLSTM`` (``return_sequences`` on and off), the stacks
  and the two models in eval mode within 1e-5 x max|out|; in train mode
  within 3e-5 x max|out| (flax's one-pass variance E[x²] - E[x]² against
  torch's two-pass one, as tests/test_torch_deeplab.py), the updated
  running statistics at rtol 1e-5 with atol 1e-5 x max|statistic|;
- the gradients of one train-mode loss within 1e-3 x max|grad| of their
  tensor in float32 (the recurrence over 3 steps adds no noise beyond
  that at these sizes);
- under bfloat16 autocast the carry stays float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.models import convlstm as jc
from satellite_computervision_tpu.ops import harmonics as jh
from satellite_computervision_tpu_torch.models import convlstm as tc
from satellite_computervision_tpu_torch.models import flax_to_torch
from satellite_computervision_tpu_torch.ops import harmonics as th
from satellite_computervision_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from test_torch_deeplab import random_variables, two_torch_threads  # noqa: F401

B, T, H, W, C = 2, 3, 10, 12, 3


def _variables(jmod, rng, *args):
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), *args)
    return random_variables({"batch_stats": {}, **shapes}, rng)


def _bridged(model, v):
    model.load_state_dict(flax_to_torch(v["params"], v.get("batch_stats"), model))
    return model


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _check_stats(model, v, mutated):
    stats = flax_to_torch(v["params"], jax.device_get(mutated["batch_stats"]), model)
    n = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            want = stats[name].numpy()
            np.testing.assert_allclose(buf.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(), err_msg=name)
            n += 1
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules()) > 0


def _seq(x):  # (B, T, H, W, C) numpy -> the port's (B, T, C, H, W)
    return torch.from_numpy(x).permute(0, 1, 4, 2, 3)


def test_hard_sigmoid_is_keras_not_torch():
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    got = tc.hard_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.hard_sigmoid(x)))
    assert np.abs(got - torch.nn.functional.hardsigmoid(torch.from_numpy(x)).numpy()).max() > 0.08
    np.testing.assert_array_equal(tc.capped_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jc.capped_relu(x)))


def test_harmonics_match_jax(rng):
    times = np.array([0, 3, 7, 11])
    np.testing.assert_allclose(th.make_harmonics(torch.from_numpy(times), 6, (5, 4)).numpy(),
                               np.asarray(jh.make_harmonics(times, 6, (5, 4))), atol=1e-6)
    s, c = th.sin_cos(2.5, 12)
    js, jcos = jh.sin_cos(2.5, 12)
    np.testing.assert_allclose([float(s), float(c)], [float(js), float(jcos)], atol=1e-6)
    series = rng.normal(size=(2, 4, 3, 3, 2)).astype(np.float32)
    got = th.add_harmonic(torch.from_numpy(series)).numpy()
    assert got.shape == (2, 4, 3, 3, 4)
    np.testing.assert_allclose(got, np.asarray(jh.add_harmonic(series)), atol=1e-6)


@pytest.mark.parametrize("dilation", [1, 3])
def test_cell_matches_jax(rng, dilation):
    f = 4
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    c0, h0 = (rng.normal(size=(B, H, W, f)).astype(np.float32) for _ in range(2))
    jcell = jc.ConvLSTMCell(f, dilation=dilation)
    v = _variables(jcell, rng, (c0, h0), x)
    (want_c, want_h), want_out = jcell.apply(v, (c0, h0), x)
    cell = _bridged(tc.ConvLSTMCell(C, f, dilation=dilation), v)
    assert cell.recurrent_conv.bias is None and cell.input_conv.dilation == (dilation,) * 2
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (c0, h0, x)]
    with torch.no_grad():
        (c, h), out = cell((nchw[0], nchw[1]), nchw[2])
    for got, want in ((c, want_c), (h, want_h), (out, want_out)):
        _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)


@pytest.mark.parametrize("return_sequences", [False, True])
def test_conv_lstm_matches_jax(rng, return_sequences):
    x = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    jmod = jc.ConvLSTM(5, dilation=3, return_sequences=return_sequences)
    v = _variables(jmod, rng, x)
    want, (want_c, want_h) = jmod.apply(v, x)
    mod = _bridged(tc.ConvLSTM(C, 5, dilation=3, return_sequences=return_sequences), v)
    with torch.no_grad():
        out, (c, h) = mod(_seq(x))
    if return_sequences:
        assert out.shape == (B, T, 5, H, W)
        _close(out.permute(0, 1, 3, 4, 2).numpy(), want, 1e-5)
    else:
        _close(out.permute(0, 2, 3, 1).numpy(), want, 1e-5)
    _close(c.permute(0, 2, 3, 1).numpy(), want_c, 1e-5)
    _close(h.permute(0, 2, 3, 1).numpy(), want_h, 1e-5)


def _stack_case(name, rng):
    if name == "stack":
        return jc.LSTMStack(6), tc.LSTMStack(C, 6)
    if name == "stack_seq":
        return jc.LSTMStack(6, return_sequences=True), tc.LSTMStack(C, 6, return_sequences=True)
    return jc.LSTMStack2(6), tc.LSTMStack2(C, 6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["stack", "stack_seq", "stack2"])
def test_stacks_match_jax(rng, name, train):
    x = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    jmod, mod = _stack_case(name, rng)
    v = _variables(jmod, rng, x)
    if train:
        want, mutated = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
    else:
        want = jax.jit(jmod.apply)(v, x)
    mod = _bridged(mod, v).train(train)
    with torch.no_grad():
        got = mod(_seq(x))
    got = got.permute(0, 1, 3, 4, 2) if got.dim() == 5 else got.permute(0, 2, 3, 1)
    assert got.shape == np.shape(want)
    _close(got.numpy(), want, 3e-5 if train else 1e-5)
    if train:
        _check_stats(mod, v, mutated)


def _model_case(name, rng):
    x = rng.normal(size=(B, T, H, W, C)).astype(np.float32)
    if name == "lstm_model":
        return jc.LSTMModel(n_classes=4, features=6), tc.LSTMModel(C, 4, features=6), (x,)
    sincos = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    return (jc.LSTMAutoencoder(n_classes=4, n_time=T, features=5),
            tc.LSTMAutoencoder(C, 4, n_time=T, features=5), (x, sincos))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["lstm_model", "lstm_autoencoder"])
def test_models_match_jax(rng, name, train):
    jmod, mod, inputs = _model_case(name, rng)
    v = _variables(jmod, rng, *inputs)
    if train:
        want, mutated = jax.jit(lambda v, *a: jmod.apply(
            v, *a, train=True, mutable=["batch_stats"]))(v, *inputs)
    else:
        want = jax.jit(jmod.apply)(v, *inputs)
    mod = _bridged(mod, v).train(train)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(a) for a in inputs))
    if name == "lstm_model":
        got, want = {"out": got}, {"out": want}
        assert got["out"].shape == (B, H, W, 4)
    else:
        assert got["temporal"].shape == (B, T, H, W, 4) and got["single"].shape == (B, H, W, 4)
    for key, g in got.items():
        assert g.dtype == torch.float32 and 0.0 <= float(g.min()) and float(g.max()) <= 2.0
        _close(g.numpy(), want[key], 3e-5 if train else 1e-5)
    if train:
        _check_stats(mod, v, mutated)


@pytest.mark.parametrize("name", ["lstm_model", "lstm_autoencoder"])
def test_gradients_match_jax(rng, name):
    """The gradients of a train-mode sum-of-squares loss against a
    target inside the cap (so the clip passes a gradient)."""
    jmod, mod, inputs = _model_case(name, rng)
    v = _variables(jmod, rng, *inputs)
    v["params"] = jax.tree_util.tree_map(lambda a: a * 0.5, v["params"])
    target = 0.5

    def jloss(params):
        out = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, *inputs,
                         train=True, mutable=["batch_stats"])[0]
        leaves = jax.tree_util.tree_leaves(out)
        return sum(jnp.sum((o - target) ** 2) for o in leaves)

    grads = jax.device_get(jax.jit(jax.grad(jloss))(v["params"]))
    want = flax_to_torch(grads, v["batch_stats"], mod)
    mod = _bridged(mod, v).train()
    out = mod(*(torch.from_numpy(a) for a in inputs))
    leaves = [out] if not isinstance(out, dict) else [out[k] for k in sorted(out)]
    sum(((o - target) ** 2).sum() for o in leaves).backward()
    n = 0
    for pname, p in mod.named_parameters():
        want_g = want[pname].numpy()
        scale = np.abs(want_g).max()
        if scale == 0.0:  # a conv bias ahead of a train-mode BN
            np.testing.assert_allclose(p.grad.numpy(), 0.0, atol=1e-6, err_msg=pname)
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0, atol=1e-3 * scale,
                                   err_msg=pname)
        n += 1
    assert n >= 8


def test_carry_stays_float32_under_bf16_autocast(rng):
    mod = tc.ConvLSTM(C, 4, return_sequences=True)
    x = _seq(rng.normal(size=(B, T, H, W, C)).astype(np.float32))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        seq, (c, h) = mod(x)
    assert seq.dtype == c.dtype == h.dtype == torch.float32
    with torch.no_grad():
        seq64, _ = mod.double()(x.double())
    assert seq64.dtype == torch.float64


@pytest.mark.parametrize("name", ["lstm_model", "lstm_autoencoder"])
def test_checkpoint_round_trip(tmp_path, rng, name):
    _, mod, inputs = _model_case(name, rng)
    mod.eval()
    save_checkpoint(str(tmp_path), mod, {"step": 3})
    blob = torch.load(tmp_path / "best" / "model.pt", weights_only=True)
    assert blob["arch"] == {"lstm_model": "convlstm"}.get(name, name)
    loaded, meta = load_checkpoint(str(tmp_path))
    assert type(loaded) is type(mod) and loaded.kwargs == mod.kwargs and meta == {"step": 3}
    with torch.no_grad():
        a, b = (m(*(torch.from_numpy(x) for x in inputs)) for m in (mod, loaded))
    for ga, gb in zip(*(jax.tree_util.tree_leaves(o) for o in (a, b))):
        torch.testing.assert_close(ga, gb, rtol=0, atol=0)
