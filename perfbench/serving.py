"""What the serving drivers share: the weights of a served model, the
program's engine over them, and the reference's answer to compare with.

The weights are drawn from the seed (:func:`perfbench.inputs.draw_weights`)
and their BatchNorm statistics calibrated once by the reference on a
few chips of the cell's imagery, so that every layer of the served model
normalizes to unit scale and its probabilities spread over (0, 1). The
program gets them as a ``state_dict`` and prepares them as its CLI does
(folding, bfloat16); the reference keeps the float32 originals.
"""

from __future__ import annotations

import gc
from typing import Dict

import numpy as np
import torch

from perfbench import counting, inputs
from perfbench.reference.layers import Ops, exact_float32
from perfbench.reference.tiling import blend_scene, to_uint8


# chips the BatchNorm statistics are calibrated on: enough that the
# image-pooling branch's statistics (one value per chip) are not degenerate
CALIBRATION_CHIPS = 8


class Served:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg = cell.config
        self.family = cell.module("families", cfg["family"])
        self.model, self.serve = cfg["model"], cfg["serve"]
        self.side = self.serve["kernel"] + self.serve["buffer"]
        self.weights_host: Dict[str, torch.Tensor] = {}
        self.engine = self.net = None

    def make_weights(self, imagery_spec: Dict) -> Dict[str, torch.Tensor]:
        dev = self.device
        weights = inputs.draw_weights(self.family.reference.specs(self.model),
                                      inputs.generator(self.seed, "weights", dev), dev)
        chips = inputs.imagery(inputs.generator(self.seed, "calibration", dev), CALIBRATION_CHIPS, self.side,
                               self.model["in_channels"], imagery_spec, dev)
        with exact_float32(), torch.no_grad():
            self.family.reference.logits(weights, chips.round(), self.model, Ops("float32"),
                                         bn="calibrate")
        self.weights_host = {k: v.cpu() for k, v in weights.items()}
        return weights

    def build_engine(self, weights):
        from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
        from satellite_computervision_tpu_torch.predict import _uint8

        s = self.serve
        self.net = self.family.serving(self.family.build(self.model, self.device, weights),
                                       s, self.device)
        net = self.net

        def predict(chips):
            return net(chips)["probs"]

        self.predict = predict
        self.engine = TiledInferenceEngine(
            predict, kernel=s["kernel"], buffer=s["buffer"], batch_size=s["batch"],
            out_channels=self.model["n_classes"], blend=s["blend"], tile_mode="chips",
            output_transform=_uint8 if s["output"] == "uint8" else None, device=self.device)
        return self.engine

    def batch_flops(self) -> int:
        """FLOPs of one forward chip batch at the served geometry."""
        chips = torch.zeros((self.serve["batch"], self.side, self.side, self.model["in_channels"]),
                            device=self.device)

        def run():
            with torch.inference_mode():
                self.predict(chips)

        return counting.count_flops(run)

    def batches(self, h: int, w: int) -> int:
        """Forward batches the engine runs for an h x w scene (its last
        group is padded to a whole batch)."""
        k, b = self.serve["kernel"], self.serve["batch"]
        return -(-(-(-h // k) * -(-w // k)) // b)

    def stitch_least_s(self, h: int, w: int, peak_bytes: float) -> float:
        k = self.serve["kernel"]
        rows, cols = -(-h // k), -(-w // k)
        return counting.hann_stitch_bytes(rows, cols, k, self.side,
                                          self.model["n_classes"]) / peak_bytes

    def free(self):
        self.engine = self.net = self.predict = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_map(self, scene: np.ndarray, precision: str) -> np.ndarray:
        """The reference's uint8 map of ``scene``, computed in ``precision``."""
        p = {k: v.to(self.device) for k, v in self.weights_host.items()}
        ops = Ops(precision)

        if self.model["head"] != "sigmoid":
            raise ValueError("the serving cells compare a sigmoid head's probabilities")

        def probs_fn(chips):
            return torch.sigmoid(self.family.reference.logits(p, chips, self.model, ops))

        s = self.serve
        with exact_float32(), torch.no_grad():
            probs = blend_scene(torch.from_numpy(scene).to(self.device), probs_fn, s["kernel"],
                                s["buffer"], s["batch"])
            return to_uint8(probs).cpu().numpy()


def compare_maps(pairs, block: int) -> Dict[str, float]:
    """Readings over (program map, reference map) pairs, in uint8 levels:

    - ``mean_abs_u8``: the mean absolute difference over every sampled
      pixel, which holds the map as a whole;
    - ``worst_block_mean_abs_u8``: the largest mean absolute difference
      of one ``block`` x ``block`` square of the output grid (the core of
      one served chip), which holds each chip's answer on its own.

    A map of the wrong shape or dtype reads as infinitely far."""
    total = count = 0
    worst = 0.0
    for prog, ref in pairs:
        if prog is None or prog.shape != ref.shape or prog.dtype != np.uint8:
            return {"mean_abs_u8": float("inf"), "worst_block_mean_abs_u8": float("inf")}
        d = np.abs(prog.astype(np.int16) - ref.astype(np.int16)).reshape(ref.shape[0], ref.shape[1], -1)
        d = d.sum(axis=2, dtype=np.int64)
        total += int(d.sum())
        count += ref.size
        per_pixel = ref.size // (ref.shape[0] * ref.shape[1])
        for i in range(0, d.shape[0], block):
            rows = d[i:i + block]
            sums = np.add.reduceat(rows.sum(axis=0), np.arange(0, d.shape[1], block))
            widths = np.diff(np.append(np.arange(0, d.shape[1], block), d.shape[1]))
            worst = max(worst, float((sums / (widths * rows.shape[0] * per_pixel)).max()))
    return {"mean_abs_u8": total / count, "worst_block_mean_abs_u8": worst}
