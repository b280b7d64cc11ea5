"""Multi-rank runs of the port's parallel package on the CPU (gloo).

    python tests/torch_dist_worker.py <suite> <rank> <world> <workdir>

Each rank joins a gloo group through ``file://<workdir>/pg`` (so that
concurrent test workers never race for a port), with one torch thread and
a 60 s collective timeout, reads ``<workdir>/inputs.pt`` (written by
:func:`run_ranks` in the parent), runs the suite's cases and writes
``<workdir>/out_<rank>.pt``. Nothing here imports JAX: the parent test
holds the results against the JAX package.

:func:`run_ranks` starts the ranks, waits for them under one deadline and
kills the rest when one fails, so a dead peer fails its test instead of
hanging the run.
"""

import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(suite, world, inputs, workdir, timeout=180):
    """Run ``suite`` on ``world`` gloo ranks; returns the ranks' outputs."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                               str(world), workdir], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = [""] * world
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode for p in procs if p.poll() is not None):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            logs[r] = p.communicate()[0]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {suite} failed ({p.returncode}):\n{logs[r]}"
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=True)
            for r in range(world)]


# ---------------------------------------------------------------- models


def mean_model(chips):
    return chips.mean(dim=-1, keepdim=True)


def avg3(x):
    """3x3 box filter by shifts (needs neighbour context), as
    tests/test_spatial.py's."""
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out + torch.roll(x, (dy, dx), dims=(1, 2))
    return out[..., :1] / 9.0


MODELS = {"mean": mean_model, "avg3": avg3}
TRANSFORMS = {
    None: (None, None),
    "uint16": (lambda s: s.float() / 10000.0, lambda p: (p * 255.0).to(torch.uint8)),
}


# ---------------------------------------------------------------- suites


def spatial_suite(inputs, mesh):
    """Every case of ``inputs["cases"]`` through make_spatial_inference."""
    from satellite_computervision_tpu_torch.parallel import make_spatial_inference

    out = {}
    for name, case in inputs["cases"].items():
        pre, post = TRANSFORMS[case.get("transform")]
        run = make_spatial_inference(
            MODELS[case["model"]], mesh, kernel=case["k"], buffer=case["b"],
            batch_size=case.get("batch_size", 16), blend=case.get("blend", "overwrite"),
            tile_mode=case.get("tile_mode", "chips"), whole_multiple=case.get("whole_multiple", 32),
            preprocess_fn=pre, output_transform=post, max_rows=case.get("max_rows"),
            device="cpu")
        out[name] = run(case["scene"].numpy())
    return out


def _toy_state(inputs):
    from satellite_computervision_tpu_torch.models import UNet
    from satellite_computervision_tpu_torch.train.trainer import create_train_state

    model = UNet(2, n_classes=1, filters=(4,), factors=(2,), head="sigmoid")
    model.load_state_dict(inputs["weights"])
    return create_train_state(model, optimizer=torch.optim.SGD(
        model.parameters(), lr=inputs["lr"], momentum=inputs["momentum"]))


def parallel_suite(inputs, mesh):
    """Mesh helpers, the global BatchNorm, the data-parallel train and eval
    steps, the DCP round trip, the sharded engine and pc.predict_scene."""
    import torch.distributed as dist

    from satellite_computervision_tpu_torch.cloud import pc
    from satellite_computervision_tpu_torch.models import losses
    from satellite_computervision_tpu_torch.models.blocks import BatchNorm
    from satellite_computervision_tpu_torch.parallel import (
        GlobalBatchNorm,
        axis_size,
        ShardedTiledInference,
        data_sharding,
        host_local_batch_to_global,
        make_mesh,
        make_parallel_eval_step,
        make_parallel_train_step,
        make_spatial_inference,
        shard_batch,
        shard_train_state,
    )
    from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager, unwrap

    world = dist.get_world_size()
    out = {}

    # ---- meshes and rank-local batches
    inferred = make_mesh([("data", -1)])
    two_d = make_mesh([("data", 2), ("model", -1)])
    try:
        make_mesh([("data", world - 1)])
        covered = False
    except ValueError:
        covered = True
    gx, gy = inputs["x"], inputs["y"]
    sh = data_sharding(mesh)
    local_x, local_y = shard_batch((gx.numpy(), gy.numpy()), mesh)
    out["mesh"] = torch.tensor([axis_size(inferred), axis_size(two_d, "data"),
                                axis_size(two_d, "model"), int(covered), sh.index, sh.size,
                                mesh.get_local_rank("data")])
    out["local_x"] = local_x
    out["host_local"] = host_local_batch_to_global(local_x, mesh)

    # ---- the global BatchNorm on this rank's slice against the plain one
    # on the whole batch (the parent compares): output, input gradient,
    # running statistics
    bn_in = inputs["bn_x"]
    gbn = BatchNorm(bn_in.shape[1], eps=1e-3, momentum=0.1)
    gbn.__class__ = GlobalBatchNorm
    gbn.group = mesh.get_group("data")
    xs = data_sharding(mesh).local(bn_in).clone().requires_grad_(True)
    y = gbn.train()(xs)
    (y * inputs["bn_w"][: y.shape[1]].view(1, -1, 1, 1)).sum().backward()
    out["bn_out"], out["bn_grad"] = y.detach(), xs.grad
    out["bn_stats"] = torch.stack([gbn.running_mean, gbn.running_var])

    # ---- the data-parallel step, two steps, then eval on a sharded batch
    loss_fn = lambda t, p: losses.weighted_bce(t, p, pos_weight=1.0, logits=True)  # noqa: E731
    state = shard_train_state(_toy_state(inputs), mesh)
    step = make_parallel_train_step(loss_fn, mesh)
    results = [step(state, (local_x, local_y)) for _ in range(inputs["steps"])]
    out["dp_loss"] = torch.stack([r["loss"] for r in results])
    out["dp_cm"] = results[0]["cm"]
    out["dp_state"] = {k: v.clone() for k, v in unwrap(state.model).state_dict().items()}
    ev = make_parallel_eval_step(loss_fn, mesh)(state, (local_x, local_y))
    out["eval_loss"], out["eval_cm"] = ev["loss"], ev["cm"]

    # ---- torch.distributed.checkpoint round trip of the sharded state
    ckpt = CheckpointManager(inputs["ckpt"], backend="dcp")
    ckpt.save(state, step=state.step, metrics={"mean_iou": 0.25})
    fresh = shard_train_state(_toy_state(inputs), mesh)
    _, meta = ckpt.restore(fresh, "best")
    got, want = unwrap(fresh.model).state_dict(), unwrap(state.model).state_dict()
    same_model = all(torch.equal(got[k], want[k]) for k in want)
    opt_a, opt_b = state.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    same_opt = len(opt_a) > 0 and all(torch.equal(opt_a[i][n], opt_b[i][n])
                                      for i in opt_a for n in opt_a[i])
    out["dcp"] = torch.tensor([int(same_model), int(same_opt), fresh.step,
                               int(meta == {"step": state.step, "metrics": {"mean_iou": 0.25}}),
                               int(ckpt.best_metrics() == {"mean_iou": 0.25})])

    # ---- the sharded engine and pc.predict_scene(mesh=...)
    scene = inputs["scene"].numpy()
    geo = dict(kernel=32, buffer=16, batch_size=8, blend="hann", device="cpu")
    engine = ShardedTiledInference(avg3, mesh, **geo)
    out["sharded"] = engine.predict_scene(scene)
    out["pc"] = pc.predict_scene(scene, avg3, mesh=mesh, **geo)
    refusals = []
    for call in (lambda: ShardedTiledInference(avg3, mesh, kernel=32, buffer=16,
                                                batch_size=world + 2, device="cpu"),
                 lambda: pc.predict_scene(scene, avg3, kernel=32, buffer=16, mesh=mesh,
                                          tile_mode="whole", device="cpu"),
                 lambda: make_spatial_inference(avg3, mesh, kernel=32, buffer=16,
                                                blend="hann", device="cpu")(scene[:40])):
        try:
            call()
            refusals.append(0)
        except ValueError:
            refusals.append(1)
    out["refusals"] = torch.tensor(refusals)
    return out


SUITES = {"spatial": spatial_suite, "parallel": parallel_suite}


def main(suite, rank, world, workdir):
    import datetime

    import torch.distributed as dist

    from satellite_computervision_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"file://{os.path.join(workdir, 'pg')}", device="cpu",
                           num_processes=world, process_id=rank, timeout=60)
    assert dist.get_backend() == "gloo"
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
    out = SUITES[suite](inputs, make_mesh())
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier(timeout=datetime.timedelta(seconds=60))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
