#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits nonzero before the last
line):

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: nvcc builds every kernel in ``csrc/`` (all at once).
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at a small shape and at the shape the serving path gives it; kernel,
   plain and library times (CUDA events) beside the card's bound.
4. ``slice``: the solar serving path at full ``SOLAR_CONFIG`` width — the
   ``predict`` CLI (k512 + b128, batch 16, hann, grid mode, bf16,
   space-to-depth stem, folded BN) on a 1920 x 1920 x 6 scene with seeded
   random weights, GeoTIFF out and read back — with every kernel's launch
   count taken over that run; then one chip's float32 forward on the card
   (TF32 off) against the CPU, and the warm scene time.
5. ``profile``: one warm scene under ``torch.profiler``: device time by
   kernel and the device's busy share.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result. Writes scratch files under ``build/chip_smoke/``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
SCENE = (1920, 1920, 6)
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls
    (CUDA events; warm, L2 not flushed)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fold_blend(weighted, k, rows, cols, inv_w):
    """Library yardstick for hann_stitch: ``F.fold`` overlap-adds the chips,
    then the constant normalizer. Timed only; the port never calls it."""
    import torch.nn.functional as F

    n, side, _, c = weighted.shape
    h, w = (rows - 1) * k + side, (cols - 1) * k + side
    folded = F.fold(weighted.permute(3, 1, 2, 0).reshape(1, c * side * side, n),
                    output_size=(h, w), kernel_size=side, stride=k)
    canvas = F.pad(folded, (0, (cols + 1) * k - w, 0, (rows + 1) * k - h))
    return canvas[0].permute(1, 2, 0) * inv_w[..., None]


def stitch_case(torch, stitch, k, buf, rows, cols, c_out, gen, timed):
    side = k + buf
    win = torch.from_numpy(stitch.hann_window_1d(side))
    weighted = (torch.randn(rows * cols, side, side, c_out, generator=gen)
                * (win[:, None] * win[None, :])[..., None]).cuda().contiguous()
    got = stitch.hann_stitch(weighted, k, rows, cols)
    want = stitch.hann_stitch_reference(weighted, k, rows, cols)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    out = dict(shape=[rows * cols, side, side, c_out], kernel=k,
               canvas=list(got.shape), max_abs_err=err)
    if timed:
        inv_w = torch.from_numpy(stitch.hann_inverse_weights(rows, cols, k, side)).cuda()
        lib = fold_blend(weighted, k, rows, cols, inv_w)
        out["library_max_abs_err"] = (lib - want).abs().max().item()
        out["ms"] = cuda_ms(lambda: stitch.hann_stitch(weighted, k, rows, cols))
        out["plain_ms"] = cuda_ms(lambda: stitch.hann_stitch_reference(weighted, k, rows, cols))
        out["library_ms"] = cuda_ms(lambda: fold_blend(weighted, k, rows, cols, inv_w))
        n_in = weighted.numel() + (rows + 1) * k + (cols + 1) * k  # chips + wy + wx
        n_out = got.numel()
        bytes_ms = (n_in + n_out) * 4 / HBM_BYTES_PER_S * 1e3
        # one add per chip pixel, then wy*wx, 1/max and the scale per output
        ops_ms = (weighted.numel() + 3 * n_out) / F32_OPS_PER_S * 1e3
        out["bound_ms"] = max(bytes_ms, ops_ms)
        out["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return out


def randomize_(model, gen):
    """Seeded He-normal conv weights and non-trivial BatchNorm state."""
    import torch

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[0].numel() if isinstance(mod, torch.nn.Conv2d) else \
                    w.shape[0] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.01)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                mod.weight.copy_(0.8 + 0.4 * torch.rand(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from satellite_computervision_tpu_torch import predict
    from satellite_computervision_tpu_torch.geo import read_geotiff
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.kernels import _build, stitch
    from satellite_computervision_tpu_torch.models import unet_solar
    from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
    from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), python=sys.version.split()[0])

    t0 = time.perf_counter()
    libs = _build.build(_build.all_kernels())
    emit("build", seconds=time.perf_counter() - t0, libraries=[str(p.name) for p in libs])

    gen = torch.Generator().manual_seed(SEED)
    kernel, buffer, batch = SOLAR_CONFIG.serving_geometry
    rows, cols = -(-SCENE[0] // kernel), -(-SCENE[1] // kernel)
    small = stitch_case(torch, stitch, 16, 8, 3, 4, 2, gen, timed=False)
    main_shape = stitch_case(torch, stitch, kernel, buffer, rows, cols, 1, gen, timed=True)
    emit("kernels", name="hann_stitch", small=small, main_path=main_shape)
    tol = 1e-6
    check(small["max_abs_err"] <= tol and main_shape["max_abs_err"] <= tol,
          f"hann_stitch disagrees with its plain version beyond {tol}")

    # ---- the solar serving slice, through the CLI a user runs
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    model = unet_solar(in_channels=len(SOLAR_CONFIG.bands), space_to_depth=True).eval()
    randomize_(model, gen)
    ckpt = os.path.join(work, "ckpt")
    save_checkpoint(ckpt, model, {"seed": SEED})
    scene = (torch.rand(SCENE, generator=gen) * 0.4).numpy()
    scene_path = os.path.join(work, "scene.npy")
    np.save(scene_path, scene)
    out_path = os.path.join(work, "pred.tif")

    stitch.hann_stitch.launches = 0
    t0 = time.perf_counter()
    predict.main(["scene", "--input", scene_path, "--ckpt", ckpt, "--config", "solar",
                  "--fold-bn", "--device", "cuda", "--output", out_path,
                  "--crs", "EPSG:32617", "--transform", "10", "0", "500000", "0", "-10",
                  "4500000"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"hann_stitch": stitch.hann_stitch.launches}
    check(all(launches.values()), f"a kernel of the path never launched: {launches}")

    pred, meta = read_geotiff(out_path)
    check(pred.shape == SCENE[:2] + (1,), f"output shape {pred.shape}")
    check(np.isfinite(pred).all(), "non-finite output")
    check(pred.min() >= 0.0 and pred.max() <= 1.0, "probabilities outside [0, 1]")
    check(meta.get("crs") == "EPSG:32617", f"crs lost: {meta}")

    # one chip, float32, card (TF32 off) vs CPU: the same folded model
    served = predict.load_model(ckpt, torch.device("cpu"), fold_bn=True)
    chip = torch.from_numpy(scene[: kernel + buffer, : kernel + buffer])[None]
    with torch.inference_mode():
        cpu_out = served(chip)
        gpu_out = served.to("cuda")(chip.cuda())
    logit_err = (gpu_out["logits"].cpu() - cpu_out["logits"]).abs().max().item()
    logit_scale = cpu_out["logits"].abs().max().item()
    prob_err = (gpu_out["probs"].cpu() - cpu_out["probs"]).abs().max().item()
    # float32 on two devices with other conv algorithms, ~30 layers deep
    check(logit_err <= 1e-4 * max(logit_scale, 1.0),
          f"f32 card forward disagrees with the CPU: {logit_err} (scale {logit_scale})")

    # bf16 served output against the f32 forward of the same chip
    served_bf16 = predict.load_model(ckpt, torch.device("cuda"), fold_bn=True)
    with torch.inference_mode():
        bf16_probs = served_bf16(chip.cuda())["probs"].float().cpu()
    bf16_vs_f32 = (bf16_probs - cpu_out["probs"]).abs()

    engine = TiledInferenceEngine(lambda c: served_bf16(c)["probs"], kernel=kernel,
                                  buffer=buffer, batch_size=batch, blend="hann",
                                  device="cuda")
    scene_dev = torch.from_numpy(scene).cuda()
    torch.cuda.reset_peak_memory_stats()

    def run_host():
        engine.predict_scene(scene)

    def run_dev():
        engine.predict_scene(scene_dev)

    def wall_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)

    host_ms = wall_ms(run_host)
    dev_ms = wall_ms(run_dev)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    chips = (torch.rand((batch, kernel + buffer, kernel + buffer, SCENE[2]),
                        generator=gen) * 0.4).cuda()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: served_bf16(chips), iters=10, warmup=2)
    mpix = SCENE[0] * SCENE[1] / 1e6
    med_host, med_dev = host_ms[len(host_ms) // 2], dev_ms[len(dev_ms) // 2]
    emit("slice", config="solar", scene=list(SCENE), geometry=[kernel, buffer, batch],
         blend="hann", dtype="bfloat16", space_to_depth=True, fold_bn=True,
         chips=rows * cols, launches=launches, cli_seconds=cli_s,
         output_shape=list(pred.shape), output_min=float(pred.min()),
         output_max=float(pred.max()),
         f32_card_vs_cpu_max_abs_logit_err=logit_err, f32_logit_scale=logit_scale,
         f32_card_vs_cpu_max_abs_prob_err=prob_err,
         bf16_vs_f32_prob_err_max=bf16_vs_f32.max().item(),
         bf16_vs_f32_prob_err_mean=bf16_vs_f32.mean().item(),
         scene_ms_host_input=host_ms, scene_ms_device_input=dev_ms,
         scene_ms=med_host, mpix_per_s=mpix / (med_host / 1e3),
         mpix_per_s_device_input=mpix / (med_dev / 1e3),
         forward_ms_per_batch=fwd_ms, peak_mem_gib=peak_gib)

    # ---- where a warm scene's device time goes
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_dev()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies, memsets): one stream, so
    # their sum over the wall time is the device's busy share
    dev = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    dev.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in dev)
    emit("profile", wall_ms=wall, device_ms=busy if dev else "not measured",
         device_busy_share=busy / wall if dev else "not measured",
         top=[{"name": n[:90], "ms": ms, "count": c} for n, ms, c in dev[:12]])

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "hann_stitch", "route": "cuda",
        "source": "satellite_computervision_tpu_torch/csrc/hann_stitch.cu",
        "replaces": "satellite_computervision_tpu/pallas/stitch.py:130",
        "launches": launches["hann_stitch"], "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
