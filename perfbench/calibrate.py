"""Readings behind the correctness limits, many seeds in one process.

    python3 perfbench/calibrate.py --workload solar.train --seeds 1 2 3 --seconds 2 --control 3

For each seed: set-up, a short window at the cell's own load, then the
compared numbers of the program against the float32 reference, one JSON
line each. ``--control N`` adds, on the first N seeds, the readings of the control: the
reference computed in float8 (e4m3, one scale per tensor) put in the
program's place. ``--fault`` plants a fault in the program first:

- ``half_batch``: the training step sees the first half of each batch,
  its mean taken over those rows;
- ``frozen``: the optimizer's step leaves the state unchanged;
- ``altered``: the served map has one block of 64 x 64 pixels inverted;
- ``wrong_slot``: in every forward chip batch, the first slot answers
  with the second slot's map (one chip in a batch of 16 wrong).

``--float32`` serves or trains the program in float32 with TF32 off, a
second witness beside the reference where a reading looks wrong.
``--dump-trace PATH`` also writes the first seed's traced window as a
table (``perfbench.tracing``). The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def plant(fault: str, driver):
    """Break the program under ``driver`` as ``fault`` names."""
    import torch

    if fault == "half_batch":
        def step(raw):
            x, y = driver.preprocess(raw, driver.augment, train=True)
            h = x.shape[0] // 2
            return driver.step_fn(driver.state, (x[:h], y[:h]))

        driver._step = step
    elif fault == "frozen":
        torch.optim.Adam.step = lambda self, closure=None: None
    elif fault == "altered":
        from satellite_computervision_tpu_torch.inference import TiledInferenceEngine

        finish = TiledInferenceEngine._finish

        def altered(self, out):
            out = out.clone()
            out[:64, :64] = 1.0 - out[:64, :64]
            return finish(self, out)

        TiledInferenceEngine._finish = altered
    elif fault == "wrong_slot":
        build = driver.served.build_engine

        def build_wrong(weights):
            engine = build(weights)
            predict = engine.predict_fn

            def wrong(chips):
                out = predict(chips).clone()
                out[0] = out[1]
                return out

            engine.predict_fn = wrong
            return engine

        driver.served.build_engine = build_wrong
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0, metavar="N",
                    help="add the control's readings on the first N seeds")
    ap.add_argument("--fault", choices=["half_batch", "frozen", "altered", "wrong_slot"])
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--dump-trace")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(HERE.parent))

    import torch

    from perfbench import manifest, tracing

    device = torch.device("cuda", 0)
    cell = manifest.resolve(args.workload)
    if args.float32:
        cell.config["serve"]["dtype"] = "float32"
        cell.config["train"]["autocast"] = "float32"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    Driver = cell.module("drivers", cell.traffic["driver"]).Driver
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        driver = Driver(cell, seed, device)
        plant(args.fault, driver)
        driver.setup()
        setup_s = time.perf_counter() - t0
        if args.dump_trace and i == 0:
            with tracing.profiled(device) as prof:
                with tracing.span("window"):
                    win = driver.window(args.seconds)
            prof["table"]["layer"] = {k: v for k, v in win["layer"].items() if k != "input_wait_s"}
            with open(args.dump_trace, "w") as f:
                json.dump(prof["table"], f)
        else:
            win = driver.window(args.seconds)
        driver.finish()
        out = {"seed": seed, "setup_s": setup_s, "e2e": win["e2e"], "attempted": win["attempted"],
               "failed": win["failed"], "program": driver.readings("float32")}
        if i < args.control:
            out["control"] = driver.readings("float8", control=True)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del driver
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
