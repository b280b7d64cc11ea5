"""The port's parallel package on 4 gloo ranks against the JAX package on a
4-device submesh of the 8-device CPU mesh: meshes and rank-local batches;
the global-batch BatchNorm against the plain one over the whole batch; two
data-parallel train steps of a small U-Net from bridged weights (loss at
rtol 1e-5, parameters at rtol 1e-4 / atol 1e-6, the confusion matrix
exact: tests/test_train.py's own limits; BatchNorm running statistics at
rtol 1e-5 / atol 1e-8), under SGD with momentum in both packages (Adam
turns the zero gradient of a conv bias that feeds a train-mode BatchNorm
into steps of +-lr set by rounding, in either package); eval on a
sharded batch; the torch.distributed.checkpoint round trip of the sharded
state; the sharded engine and ``cloud.pc.predict_scene(mesh=...)`` within
atol 1e-5 of the JAX sharded engine and of the port's single-device
engine; and the refusals. One spawn of 4 ranks runs every multi-rank case
(tests/torch_dist_worker.py)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from satellite_computervision_tpu.cloud import pc as jax_pc
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models import losses as jlosses
from satellite_computervision_tpu.parallel import ShardedTiledInference as JaxSharded
from satellite_computervision_tpu.parallel import make_mesh as jax_make_mesh
from satellite_computervision_tpu.parallel import make_parallel_train_step as jax_dp_step
from satellite_computervision_tpu.parallel import shard_batch as jax_shard_batch
from satellite_computervision_tpu.parallel import shard_train_state as jax_shard_state
from satellite_computervision_tpu.train import create_train_state as jax_create_state
from satellite_computervision_tpu.train.trainer import make_eval_step as jax_eval_step
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch, losses
from satellite_computervision_tpu_torch.models.blocks import BatchNorm
from satellite_computervision_tpu_torch.parallel import initialize_distributed
from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager
from satellite_computervision_tpu_torch.train.trainer import create_train_state
from torch_dist_worker import avg3, run_ranks

WORLD, STEPS, BATCH = 4, 2, 8
LR, MOMENTUM = 0.1, 0.9
ATOL = 1e-5


def _jax_avg3(x):
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out + jnp.roll(x, (dy, dx), axis=(1, 2))
    return out[..., :1] / 9.0


def _jax_state():
    model = JaxUNet(n_classes=1, filters=(4,), factors=(2,), head="sigmoid")
    return jax_create_state(model, jax.random.key(0), jnp.zeros((1, 16, 16, 2)),
                            tx=optax.sgd(LR, momentum=MOMENTUM))


def _port_unet():
    return UNet(2, n_classes=1, filters=(4,), factors=(2,), head="sigmoid")


def _jax_loss(y, p):
    return jlosses.weighted_bce(y, p, pos_weight=1.0, logits=True)


def _batch():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(BATCH, 16, 16, 2)).astype(np.float32)
    return x, (x[..., :1] > 0.5).astype(np.float32)


def _scene():
    return np.random.default_rng(4).normal(size=(8 * 32 + 5, 2 * 32 + 3, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    state = _jax_state()
    weights = flax_to_torch(jax.device_get(state.params), jax.device_get(state.batch_stats),
                            _port_unet())
    x, y = _batch()
    rng = np.random.default_rng(5)
    inputs = dict(x=torch.from_numpy(x), y=torch.from_numpy(y), weights=weights, steps=STEPS,
                  lr=LR, momentum=MOMENTUM,
                  bn_x=torch.from_numpy(rng.normal(2.0, 3.0, (BATCH, 5, 6, 7)).astype(np.float32)),
                  bn_w=torch.from_numpy(rng.normal(size=5).astype(np.float32)),
                  scene=torch.from_numpy(_scene()), ckpt=str(work / "dcp"))
    return run_ranks("parallel", WORLD, inputs, work / "ranks"), str(work / "dcp")


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh([("data", WORLD)], devices=jax.devices()[:WORLD])


def test_mesh_and_rank_local_batches(ranks):
    outs, _ = ranks
    x, _ = _batch()
    b = BATCH // WORLD
    for r, out in enumerate(outs):
        # inferred axis, a 2 x 2 mesh, a shape not covering the ranks
        # refused, this rank's shard of the data axis
        assert out["mesh"].tolist() == [WORLD, 2, 2, 1, r, WORLD, r]
        np.testing.assert_array_equal(out["local_x"].numpy(), x[r * b : (r + 1) * b])
        np.testing.assert_array_equal(out["host_local"].numpy(), x[r * b : (r + 1) * b])


def test_global_batchnorm_matches_plain_on_the_global_batch(ranks):
    """Each rank normalizes its slice by the global batch's statistics:
    outputs, input gradients and running statistics equal those of the
    plain BatchNorm over the whole batch (one-pass against two-pass
    variance: rounding)."""
    outs, _ = ranks
    rng = np.random.default_rng(5)
    bn_x = torch.from_numpy(rng.normal(2.0, 3.0, (BATCH, 5, 6, 7)).astype(np.float32))
    bn_w = torch.from_numpy(rng.normal(size=5).astype(np.float32))
    bn = BatchNorm(5, eps=1e-3, momentum=0.1).train()
    xs = bn_x.clone().requires_grad_(True)
    y = bn(xs)
    (y * bn_w.view(1, -1, 1, 1)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([o["bn_out"] for o in outs]).numpy(),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(torch.cat([o["bn_grad"] for o in outs]).numpy(),
                               xs.grad.numpy(), **tol)
    for o in outs:
        np.testing.assert_allclose(o["bn_stats"].numpy(),
                                   torch.stack([bn.running_mean, bn.running_var]).numpy(), **tol)


def _jax_dp(jax_mesh):
    state = jax_shard_state(_jax_state(), jax_mesh)
    step = jax_dp_step(_jax_loss, jax_mesh, pred_key="logits")
    sharded = jax_shard_batch(_batch(), jax_mesh)
    results = []
    for i in range(STEPS):
        state, out = step(state, sharded, jax.random.key(i))
        results.append(out)
    return state, sharded, results


def test_dp_step_matches_jax(ranks, jax_mesh):
    outs, _ = ranks
    state, _, results = _jax_dp(jax_mesh)
    want = flax_to_torch(jax.device_get(state.params), jax.device_get(state.batch_stats),
                         _port_unet())
    for out in outs:
        np.testing.assert_allclose(out["dp_loss"].numpy(),
                                   [float(r["loss"]) for r in results], rtol=1e-5)
        np.testing.assert_array_equal(out["dp_cm"].numpy(), np.asarray(results[0]["cm"]))
        for key, value in want.items():
            got = out["dp_state"][key]
            if key.endswith("num_batches_tracked"):
                assert int(got) == STEPS
            elif "running" in key:
                np.testing.assert_allclose(got.numpy(), value.numpy(), rtol=1e-5, atol=1e-8,
                                           err_msg=key)
            else:
                np.testing.assert_allclose(got.numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=key)


def test_eval_with_a_sharded_batch_matches_jax(ranks, jax_mesh):
    outs, _ = ranks
    state, sharded, _ = _jax_dp(jax_mesh)
    want = jax_eval_step(_jax_loss, pred_key="logits")(state, sharded)
    for out in outs:
        np.testing.assert_allclose(float(out["eval_loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(out["eval_cm"].numpy(), np.asarray(want["cm"]))


def test_dcp_roundtrip_of_the_sharded_state(ranks):
    """Every rank saved; the restore into a fresh sharded state is
    bit-equal (weights, BatchNorm buffers, Adam moments) with its step
    and meta; rank 0 alone wrote the meta."""
    outs, ckpt = ranks
    for out in outs:
        assert out["dcp"].tolist() == [1, 1, STEPS, 1, 1]
    for which in ("best", "latest"):
        files = os.listdir(os.path.join(ckpt, which))
        assert ".metadata" in files and "model.pt" not in files
        with open(os.path.join(ckpt, which, "scv_meta.json")) as f:
            assert json.load(f) == {"step": STEPS, "metrics": {"mean_iou": 0.25}}


def test_sharded_engine_matches_jax_and_engine(ranks, jax_mesh):
    outs, _ = ranks
    scene = _scene()
    geo = dict(kernel=32, buffer=16, batch_size=8, blend="hann")
    want_jax = np.asarray(JaxSharded(_jax_avg3, jax_mesh, **geo).predict_scene(scene))
    want_port = TiledInferenceEngine(avg3, device="cpu", **geo).predict_scene(scene).numpy()
    for out in outs:
        got = out["sharded"].numpy()
        assert got.shape == scene.shape[:2] + (1,)
        for want, what in ((want_jax, "JAX"), (want_port, "engine")):
            err = float(np.abs(got - want).max())
            assert err <= ATOL, f"against the {what}: max abs err {err}"


def test_pc_predict_scene_under_a_mesh(ranks, jax_mesh):
    outs, _ = ranks
    scene = _scene()
    want = np.asarray(jax_pc.predict_scene(scene, _jax_avg3, kernel=32, buffer=16,
                                           batch_size=8, mesh=jax_mesh, blend="hann"))
    for out in outs:
        np.testing.assert_array_equal(out["pc"].numpy(), out["sharded"].numpy())
        err = float(np.abs(out["pc"].numpy() - want).max())
        assert err <= ATOL, f"against JAX: max abs err {err}"


def test_refusals_under_a_mesh(ranks):
    """A batch the data axis does not divide, whole mode under the sharded
    engine (JAX's message), and a scene too short for the hann halo."""
    outs, _ = ranks
    for out in outs:
        assert out["refusals"].tolist() == [1, 1, 1]


def test_dcp_roundtrip_without_a_process_group(tmp_path):
    """One process, no group: the dcp backend writes and restores alone."""
    torch.manual_seed(0)
    state = create_train_state(_port_unet(), 1e-2)  # Adam: its moments restored too
    x, y = (torch.from_numpy(a) for a in _batch())
    from satellite_computervision_tpu_torch.train.trainer import make_train_step

    step = make_train_step(lambda t, p: losses.weighted_bce(t, p, 1.0, logits=True))
    step(state, (x, y))
    manager = CheckpointManager(str(tmp_path), backend="dcp")
    manager.save(state, step=state.step, metrics={"mean_iou": 0.5})
    fresh = create_train_state(_port_unet(), 1e-2)
    _, meta = manager.restore(fresh, "latest")
    assert meta == {"step": 1, "metrics": {"mean_iou": 0.5}} and fresh.step == 1
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    a, b = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i][n], b[i][n]) for i in a for n in a[i])
    assert manager.best_metrics() == {"mean_iou": 0.5}
    with pytest.raises(ValueError, match="backend"):
        CheckpointManager(str(tmp_path), backend="orbax")


def test_initialize_distributed_is_a_noop_without_a_coordinator():
    import torch.distributed as dist

    initialize_distributed(None, device="cpu")
    assert not dist.is_initialized()
