"""Training steps as the training CLI runs them: ``TrainIterator``
(shuffle buffer, batches, pinned copies on a side stream) over decoded
chips held in host memory, ``make_preprocess_fn`` (per-chip, per-band
rescale with augmentation: the CUDA ``fused_preprocess``), and the train
step of ``train/trainer.py`` under the configuration's autocast.

Traffic parameters: ``pool_chips`` chips drawn from the seed with
``imagery``, ``shuffle_buffer``, ``prefetch``, ``warm_steps`` and
``trace_seconds``. The batch, tile, bands, loss (weighted BCE on
logits, the only one driven) and optimizer (Adam, the same) are the
configuration's ``train`` section.

Set-up builds one training state and drives it through its first three
steps with the window's own call and feed; the window continues from the
same state, and runs until the first step dispatched after ``seconds``
has finished on the device. After it, the same state takes three more
steps through the same call and feed (:meth:`Driver.finish`). The
reference follows both sets of three (see :meth:`Driver.readings`): the
first from the seed's weights and a fresh Adam, the last from the
program's parameters and Adam moments as the window left them.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from perfbench import counting, inputs
from perfbench.reference import preprocess as ref_preprocess
from perfbench.reference.layers import Ops, exact_float32
from perfbench.reference.train import BETA1, run_steps
from perfbench.tracing import span

CHECKED_STEPS = 3
NUMBERS = ("loss_gap_first", "loss_gap", "grad_norm_gap", "grad_norm_gap_median", "update_norm_gap")
TRAINABLE = ("weight", "bias", "bn_weight", "bn_weight_residual", "bn_bias")


class PoolDataset:
    """Decoded EE-schema chips in host memory, in pool order: the
    dataset object the training iterator reads, with TFRecord decoding
    left out."""

    def __init__(self, pool, feature_names):
        self.pool, self.feature_names = pool, list(feature_names)
        self.n = len(pool[self.feature_names[0]])

    def __iter__(self):
        for i in range(self.n):
            yield {name: self.pool[name][i] for name in self.feature_names}


def _fingerprint(rows: np.ndarray) -> bytes:
    return np.ascontiguousarray(rows, dtype=np.float32).tobytes()


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.t = cell.traffic
        cfg = cell.config
        self.family = cell.module("families", cfg["family"])
        self.model, self.tr = cfg["model"], cfg["train"]
        if self.tr["loss"] != "weighted_bce_logits" or self.tr["optimizer"] != "adam":
            raise ValueError("the training driver runs weighted_bce_logits under adam only")
        self.bands = list(self.tr["bands"])
        self.response = self.tr["response"]
        self.early = self.late = None

    # ---------------------------------------------------------------- set-up
    def setup(self):
        from satellite_computervision_tpu_torch.data.pipeline import (
            TrainIterator,
            make_preprocess_fn,
        )
        from satellite_computervision_tpu_torch.models import losses
        from satellite_computervision_tpu_torch.train.trainer import (
            create_train_state,
            make_train_step,
        )

        t, tr, dev = self.t, self.tr, self.device
        self.pool = inputs.chip_pool(inputs.generator(self.seed, "pool", dev), t["pool_chips"],
                                     tr["tile"], self.bands, self.response, t["imagery"], dev)
        self.index = {_fingerprint(r): i for i, r in enumerate(self._keys(self.pool[self.bands[0]]))}
        self.specs = self.family.reference.specs(self.model)
        weights = inputs.draw_weights(self.specs, inputs.generator(self.seed, "weights", dev), dev)
        self.weights_host = {k: v.cpu() for k, v in weights.items()}
        net = self.family.build(self.model, dev, weights).to(memory_format=torch.channels_last)
        del weights
        self.state = create_train_state(net, tr["lr"])
        pos_weight = tr["pos_weight"]

        def loss_fn(y, p):
            return losses.weighted_bce(y, p, pos_weight=pos_weight, logits=True)

        autocast = torch.bfloat16 if tr["autocast"] == "bfloat16" and dev.type == "cuda" else None
        self.step_fn = make_train_step(loss_fn, "logits", num_classes=max(2, self.model["n_classes"]),
                                       compute_dtype=autocast)
        self.preprocess = make_preprocess_fn(self.bands, self.response, axes=tuple(tr["axes"]),
                                             device=dev)
        self.augment = torch.Generator().manual_seed(inputs.subseed(self.seed, "augment"))
        iterator = TrainIterator(PoolDataset(self.pool, self.bands + [self.response]),
                                 batch_size=tr["batch"], shuffle_buffer=t["shuffle_buffer"],
                                 repeat=True, seed=inputs.subseed(self.seed, "shuffle"),
                                 prefetch=t["prefetch"], device=dev)
        self.stream = iter(iterator)

        self.early = self._checked_steps(None)
        raw = next(self.stream)
        self.flops_per_step = counting.count_flops(lambda: self._step(raw))
        for _ in range(t["warm_steps"]):
            self._step(next(self.stream))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _moment(self, p, key):
        state = self.state.optimizer.state.get(p, {})
        return state[key].detach().clone() if key in state else torch.zeros_like(p)

    def _checked_steps(self, start) -> dict:
        """``CHECKED_STEPS`` steps through the window's own call and feed:
        the chips of each batch, its loss, the first gradient as Adam
        holds it (from its first moment before and after the step) and
        each leaf's change over the steps."""
        params = dict(self.state.model.named_parameters())
        m0 = {k: self._moment(p, "exp_avg") for k, p in params.items()}
        before = {k: p.detach().clone() for k, p in params.items()}
        rec = {"start": start, "batch_ids": [], "losses": []}
        for s in range(CHECKED_STEPS):
            raw = next(self.stream)
            rec["batch_ids"].append(self._identify(raw))
            rec["losses"].append(float(self._step(raw)["loss"]))
            if s == 0:
                rec["grads"] = {k: float((self._moment(p, "exp_avg") - BETA1 * m0[k]).norm())
                                / (1 - BETA1) for k, p in params.items()}
                del m0
        rec["updates"] = {k: float((p.detach() - before[k]).norm()) for k, p in params.items()}
        return rec

    @staticmethod
    def _keys(first_band):
        """Each chip's first eight values of its first row: unique to a
        chip of drawn imagery."""
        return first_band[:, 0, :8]

    def _identify(self, raw) -> list:
        keys = self._keys(raw[self.bands[0]]).float().cpu().numpy()
        return [self.index.get(_fingerprint(r), -1) for r in keys]

    def _step(self, raw):
        with span("preprocess"):
            x, y = self.preprocess(raw, self.augment, train=True)
        with span("step"):
            return self.step_fn(self.state, (x, y))

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        from satellite_computervision_tpu_torch.kernels.preprocess import fused_preprocess

        launches0 = fused_preprocess.launches
        waits, steps, failed = [], 0, 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            try:
                with span("next_batch"):
                    raw = next(self.stream)
                waits.append(time.perf_counter() - a)
                self._step(raw)
            except Exception as e:  # noqa: BLE001 - a failed step counts and ends the window
                failed += 1
                print(f"step {steps} failed: {e!r}", file=sys.stderr, flush=True)
                break
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        tr = self.tr
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        layer = {"device_name": name, "step_flops": steps * self.flops_per_step,
                 "input_wait_s": waits}
        hbm = counting.peak(name, "hbm_byte_s")
        if hbm:
            calls = fused_preprocess.launches - launches0
            n_color = len(self.bands)
            per_call = counting.fused_preprocess_bytes(tr["batch"], tr["tile"], n_color + 1,
                                                       n_color) / hbm
            layer["kernels"] = {"fused_preprocess": {"calls": calls, "least_s": calls * per_call}}
        return {"attempted": steps + failed, "failed": failed, "window_s": t1 - t0,
                "e2e": {"train_chips_s": steps * tr["batch"] / (t1 - t0)}, "layer": layer}

    def finish(self):
        """After the window: a snapshot of the parameters, Adam's moments
        and step counts and the augmentation generator, then
        ``CHECKED_STEPS`` more steps of the same state, call and feed;
        then the program's state is freed."""
        import gc

        try:
            params = dict(self.state.model.named_parameters())
            opt = self.state.optimizer.state
            start = {"params": {k: p.detach().to("cpu", copy=True) for k, p in params.items()},
                     "m": {k: self._moment(p, "exp_avg").cpu() for k, p in params.items()},
                     "v": {k: self._moment(p, "exp_avg_sq").cpu() for k, p in params.items()},
                     "t": {k: int(opt[p]["step"]) if "step" in opt.get(p, {}) else 0
                           for k, p in params.items()},
                     "augment": self.augment.get_state()}
            self.late = self._checked_steps(start)
        except Exception as e:  # noqa: BLE001 - no late readings: the check fails
            print(f"the steps after the window failed: {e!r}", file=sys.stderr, flush=True)
        self.state = self.step_fn = self.stream = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correctness
    def _reference(self, rec: dict, precision: str):
        """(losses, first-step gradient norms, update norms) of the
        reference over the chips and draws of the checked steps ``rec``,
        from where they started."""
        dev, tr, start = self.device, self.tr, rec["start"]
        params = {k: v.to(dev).clone() for k, v in self.weights_host.items()}
        gen = torch.Generator()
        state = None
        if start is None:
            gen.manual_seed(inputs.subseed(self.seed, "augment"))
        else:
            params.update({k: v.to(dev).clone() for k, v in start["params"].items()})
            gen.set_state(start["augment"])
            state = {"m": {k: v.to(dev) for k, v in start["m"].items()},
                     "v": {k: v.to(dev) for k, v in start["v"].items()}, "t": start["t"]}
        trainable = [name for name, _, kind, _ in self.specs if kind in TRAINABLE]
        origin = {k: params[k].clone() for k in trainable}
        batches = []
        for ids in rec["batch_ids"]:
            bands = torch.from_numpy(np.stack([self.pool[b][ids] for b in self.bands], -1))
            labels = torch.from_numpy(self.pool[self.response][ids][..., None])
            drawn = ref_preprocess.draws(gen, len(ids), len(self.bands))
            batches.append(ref_preprocess.preprocess(bands.to(dev), labels.to(dev), drawn))
        ops = Ops(precision)

        def logits(p, x):
            return self.family.reference.logits(p, x, self.model, ops, bn="train")

        with exact_float32():
            losses, first = run_steps(params, trainable, batches, logits, tr["pos_weight"], tr["lr"],
                                      state)
        grads = {k: float(first[k].norm()) for k in trainable}
        updates = {k: float((params[k] - origin[k]).norm()) for k in trainable}
        return losses, grads, updates

    def _compared(self, rec, precision: str, control: bool, unique: bool) -> dict:
        ids = [i for b in rec["batch_ids"] for i in b] if rec else [-1]
        if min(ids) < 0 or (unique and len(set(ids)) != len(ids)):
            # no steps, a chip that is not the pool's, or one fed twice
            # where set-up's steps, in the pool's first pass, each take new ones
            return {name: float("inf") for name in NUMBERS}
        ref_losses, ref_grads, ref_updates = self._reference(rec, "float32")
        if control:
            losses, grads, updates = self._reference(rec, precision)
        else:
            losses, grads, updates = rec["losses"], rec["grads"], rec["updates"]
        return compare_steps(losses, grads, updates, ref_losses, ref_grads, ref_updates)

    def readings(self, precision: str = "float32", control: bool = False) -> dict:
        """The compared numbers of set-up's checked steps, and the same of
        the steps after the window under ``late_`` names."""
        out = self._compared(self.early, precision, control, unique=True)
        late = self._compared(self.late, precision, control, unique=False)
        out.update({f"late_{k}": v for k, v in late.items()})
        return out


def _gaps(ours: dict, ref: dict, keys) -> list:
    floor = statistics.median(ref[k] for k in keys)
    return [abs(ours.get(k, float("inf")) - ref[k]) / max(ref[k], floor) for k in keys]


def _gap(ours: dict, ref: dict, keys) -> float:
    return max(_gaps(ours, ref, keys))


def compare_steps(losses, grads, updates, ref_losses, ref_grads, ref_updates) -> dict:
    """The readings of the checked steps:

    - ``loss_gap_first``: the relative gap of the first step's loss, a
      forward pass from the same weights on both sides;
    - ``loss_gap``: the largest relative gap of a step's loss (after the
      first, Adam's first moves, as large for a gradient of rounding as
      for any, make the steps part: not compared, PERF.md);
    - ``grad_norm_gap``: of the first step's gradient, the worst leaf's
      gap of norms over the larger of the reference leaf's norm and the
      median leaf's;
    - ``grad_norm_gap_median``: the median leaf's gap of the same, steady
      from seed to seed where the worst leaf's swings;
    - ``update_norm_gap``: the worst leaf's gap of the parameters' change
      over the checked steps.

    Both leave out the leaves whose reference gradient is under a
    thousandth of the median leaf's: there the gradient is nought but for
    rounding (a conv bias before a training-mode BatchNorm), the
    program's reads its own rounding, and Adam moves the leaf by it."""
    if len(losses) != len(ref_losses):
        return {name: float("inf") for name in NUMBERS}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    keys = sorted(ref_grads)
    floor = statistics.median(ref_grads[k] for k in keys)
    moving = [k for k in keys if ref_grads[k] >= 1e-3 * floor]
    return {"loss_gap_first": gaps[0], "loss_gap": max(gaps),
            "grad_norm_gap": _gap(grads, ref_grads, moving),
            "grad_norm_gap_median": statistics.median(_gaps(grads, ref_grads, moving)),
            "update_norm_gap": _gap(updates, ref_updates, moving),
            "worst_leaves": {"grad": _worst(grads, ref_grads, moving),
                             "update": _worst(updates, ref_updates, moving)}}


def _worst(ours: dict, ref: dict, keys, n: int = 4):
    """The ``n`` leaves with the largest gaps: [name, ours, reference]."""
    floor = statistics.median(ref[k] for k in keys)
    ranked = sorted(keys, key=lambda k: -abs(ours.get(k, float("inf")) - ref[k]) / max(ref[k], floor))
    return [[k, ours.get(k), ref[k]] for k in ranked[:n]] + [["median", None, floor]]
