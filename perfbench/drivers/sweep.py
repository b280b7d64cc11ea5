"""Closed-loop offline sweep: whole scenes through the engine's pipelined
``predict_scenes(readback=True)``, the CLI's ``sweep``.

Traffic parameters: ``scene_side``, ``distinct_scenes`` (drawn from the
seed and cycled), ``prefetch``, ``imagery`` (see ``perfbench.inputs``),
``check_scenes`` answers compared, drawn from the seed among the first
``check_within``, and ``trace_seconds``.

The window runs until the first scene completed after ``seconds`` (and
at least until the checked scenes are done, which only a short traced
window reaches); its rate is the megapixels of every completed scene over
the whole window.
"""

from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from perfbench import counting, inputs
from perfbench.serving import Served, compare_maps
from perfbench.tracing import span


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.t = cell.traffic
        self.served = Served(cell, seed, device)
        self.kept = {}

    def setup(self):
        t, dev = self.t, self.device
        weights = self.served.make_weights(t["imagery"])
        self.served.build_engine(weights)
        del weights
        side, bands = t["scene_side"], self.served.model["in_channels"]
        self.scenes = inputs.host_images(inputs.generator(self.seed, "scenes", dev),
                                         t["distinct_scenes"], side, bands, t["imagery"], dev)
        rng = random.Random(inputs.subseed(self.seed, "check"))
        self.check = set(rng.sample(range(t["check_within"]), t["check_scenes"]))
        # every distinct scene once: the staging ring and the read-back
        # buffers (pinned host memory) are allocated here, not in the window
        for _ in self.served.engine.predict_scenes(iter(self.scenes), prefetch=t["prefetch"],
                                                   readback=True):
            pass
        self.flops_per_batch = self.served.batch_flops()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _feed(self):
        i = 0
        while True:
            yield self.scenes[i % len(self.scenes)]
            i += 1

    def window(self, seconds: float) -> dict:
        from satellite_computervision_tpu_torch.kernels.stitch import hann_stitch

        engine, t = self.served.engine, self.t
        launches0 = hann_stitch.launches
        done = attempted = failed = 0
        stream = engine.predict_scenes(self._feed(), prefetch=t["prefetch"], readback=True)
        t0 = t1 = time.perf_counter()
        try:
            while True:
                attempted += 1
                try:
                    with span("scene"):
                        pred = next(stream)
                except Exception as e:  # noqa: BLE001 - a failed scene counts and ends the stream
                    failed += 1
                    print(f"scene {attempted - 1} failed: {e!r}", file=sys.stderr, flush=True)
                    t1 = time.perf_counter()
                    break
                if done in self.check:
                    self.kept[done] = pred
                done += 1
                t1 = time.perf_counter()
                if t1 - t0 >= seconds and done > max(self.check):
                    break
        finally:
            stream.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        h, w = self.scenes.shape[1:3]
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        launches = hann_stitch.launches - launches0
        hbm = counting.peak(name, "hbm_byte_s")
        layer = {"device_name": name,
                 "forward_flops": done * self.served.batches(h, w) * self.flops_per_batch}
        if hbm:
            layer["kernels"] = {"hann_stitch": {
                "calls": launches, "least_s": launches * self.served.stitch_least_s(h, w, hbm)}}
        return {"attempted": attempted, "failed": failed, "window_s": t1 - t0,
                "e2e": {"serve_mpix_s": done * h * w / 1e6 / max(t1 - t0, 1e-9)}, "layer": layer}

    def finish(self):
        """After the window: the program's state freed."""
        self.served.free()

    def readings(self, precision: str = "float32", control: bool = False) -> dict:
        """Compared numbers over the kept answers. With ``control`` the
        reference in ``precision`` stands in for the program and is held
        against the float32 reference."""
        if not self.kept:
            return compare_maps([(None, np.zeros(1, np.uint8))], 1)
        refs, pairs = {}, []
        for i in sorted(self.kept):
            j = i % len(self.scenes)
            if j not in refs:
                refs[j] = self.served.reference_map(self.scenes[j], "float32")
            prog = self.served.reference_map(self.scenes[j], precision) if control else self.kept[i]
            pairs.append((prog, refs[j]))
        return compare_maps(pairs, self.served.serve["kernel"])
