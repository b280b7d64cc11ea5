"""Full-scene prediction CLI — the port of ``scripts/predict.py``.

Modes:
  scene:   a .npy (H, W, C) or GeoTIFF scene -> tiled inference ->
           GeoTIFF/COG (banded with ``--max-rows``, streamed disk to disk;
           nodata chips culled with ``--nodata``, which defaults to the
           input GeoTIFF's nodata tag)
  sweep:   a directory or glob of scenes -> one engine, scenes pipelined
           (staging / compute / read-back threads), one GeoTIFF each
  patches: a directory of EE-exported TFRecord patches + mixer.json ->
           batched prediction -> EE-ingestable TFRecords
  change:  a before and an after scene (.npy or GeoTIFF, same shape) ->
           one engine pass over their 2C-band stack, the Siamese model
           splitting each chip at C -> change probability GeoTIFF/COG

``--model`` picks the family (default: the config's, ``siamese`` for
``--config change``); ``change`` mode serves the siamese family, the other
modes the unet family or ``deeplab`` (DeepLab v3+, the parking-lot model;
BN is not folded for it). The checkpoint is ``<ckpt>/best/model.pt`` (the
port's format, which records the architecture) or
``<ckpt>/best/state.msgpack`` (the JAX package's, built as the config's
model of that family). On CUDA the model serves in bfloat16; on the CPU
(``--device cpu``) in float32. Outputs carry the transform, CRS and
compression, as the JAX CLI writes them, and no nodata tag: ``--nodata``
(or the input's tag) only culls chips.

The serving geometry is, in this order: the ``--kernel``/``--buffer``/
``--tile-mode`` flags; else the best row of the tune table
``<ckpt>/tune_torch.json`` when every row was measured on this device;
else the preset's. ``scene --tune`` times the candidate geometries on the
device (``inference.tune``), serves the fastest and writes that table.
The JAX package's ``<ckpt>/tune.json`` was measured on another device: it
is reported and ignored.

Examples::

  python -m satellite_computervision_tpu_torch.predict scene \\
      --input scene.npy --ckpt runs/solar --config solar --fold-bn \\
      --output pred.tif --crs EPSG:32617 --transform 10 0 500000 0 -10 4500000
  python -m satellite_computervision_tpu_torch.predict scene \\
      --input swath.tif --ckpt runs/solar --fold-bn --max-rows 2688 \\
      --nodata 0 --cog --uint8 --predictor 2 --output swath_pred.tif
  python -m satellite_computervision_tpu_torch.predict scene --config parking \\
      --model deeplab --input naip.tif --ckpt runs/parking --tune \\
      --cog --uint8 --predictor 2 --output lots.tif
  python -m satellite_computervision_tpu_torch.predict sweep \\
      --input scenes/ --ckpt runs/solar --fold-bn --outdir preds/ --prefetch 2
  python -m satellite_computervision_tpu_torch.predict patches \\
      --input exports/ --ckpt runs/solar --outdir preds/ --base solar_md
  python -m satellite_computervision_tpu_torch.predict change --config change \\
      --input-before before.npy --input-after after.npy --ckpt runs/change \\
      --nodata 0 --cog --uint8 --predictor 2 --output change.tif
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.geo import GeoTiffScene, write_cog, write_geotiff
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine, read_mixer
from satellite_computervision_tpu_torch.inference.batch import (
    list_export_files,
    run_batch_prediction,
)
from satellite_computervision_tpu_torch.inference.tune import (
    device_name,
    load_tune_table,
    save_tune_table,
    tune_engine_geometry,
)
from satellite_computervision_tpu_torch.models import UNet, fold_unet
from satellite_computervision_tpu_torch.train.checkpoint import (
    Model,
    arch_of,
    build_empty,
    load_checkpoint,
    load_flax_weights,
    read_flax_checkpoint,
)
from satellite_computervision_tpu_torch.train.config import CONFIGS, SOLAR_CONFIG
from satellite_computervision_tpu_torch.train.zoo import get_family


# the port's tune table beside the checkpoint; the JAX package's is
# JAX_TUNE_TABLE (its reader refuses rows that carry a device)
TUNE_TABLE = "tune_torch.json"
JAX_TUNE_TABLE = "tune.json"


def resolve_serving_geometry(cfg, args, ckpt_dir=None, device="cpu"):
    """The serving geometry, in precedence order: explicit ``--kernel`` /
    ``--buffer`` / ``--tile-mode`` flags (any of them skips the table);
    the best row of ``<ckpt>/tune_torch.json`` when every row names
    ``device``; the preset's ``serving_geometry``. ``--batch-size``
    overrides the batch either way. Returns (kernel, buffer, batch,
    tile_mode, source-string).

    A table measured on another device (or a JAX ``tune.json``, whose rows
    name none) must not pick this device's geometry: it is reported and
    ignored."""
    kernel, buffer, batch = cfg.serving_geometry
    tile_mode, source = args.tile_mode, "preset"
    explicit = args.kernel is not None or args.buffer is not None or args.tile_mode != "chips"
    if ckpt_dir:
        jax_table = os.path.join(ckpt_dir, JAX_TUNE_TABLE)
        if os.path.exists(jax_table):
            print(f"note: ignoring tune table {jax_table} (the JAX package's, measured "
                  "on another device)")
        table = os.path.join(ckpt_dir, TUNE_TABLE)
        if os.path.exists(table):
            rows = load_tune_table(table)
            here = device_name(device)
            if explicit:
                print(f"note: ignoring tune table {table} (explicit geometry flags)")
            elif rows and all(r.device == here for r in rows):
                best = rows[0]
                source = f"tune table ({best.ms:.1f} ms/scene)"
                if best.tile_mode == "whole":
                    tile_mode = "whole"
                else:
                    kernel, buffer, tile_mode = best.kernel, best.buffer, "chips"
            else:
                measured = sorted({str(r.device) for r in rows})
                print(f"note: ignoring tune table {table} (measured on {measured}, "
                      f"not {here!r}); serving the preset/flag geometry")
    if args.kernel is not None:
        kernel, source = args.kernel, "flags"
    if args.buffer is not None:
        buffer, source = args.buffer, "flags"
    if args.batch_size is not None:
        batch = args.batch_size
    return kernel, buffer, batch, tile_mode, source


def load_scene(path, max_rows=None):
    """Scene input -> ((H, W, C) array, meta dict). ``.tif``/``.tiff``
    carries transform/crs/nodata from the file; with ``max_rows`` set and a
    taller GeoTIFF the scene stays file-backed (``geo.GeoTiffScene``: the
    banded engine decodes O(band) rows at a time). ``.npy`` loads bare,
    memory-mapped when ``max_rows`` is set."""
    if path.endswith((".tif", ".tiff")):
        sc = GeoTiffScene(path)
        if max_rows is not None and sc.shape[0] > max_rows:
            return sc, sc.meta
        return np.asarray(sc), sc.meta
    scene = np.load(path, mmap_mode="r" if max_rows is not None else None)
    return (scene[..., None] if scene.ndim == 2 else scene), {}


def load_model(ckpt_dir: str, device, s2d=None, fold_bn: bool = False,
               cfg=SOLAR_CONFIG, arch: str = "unet") -> Model:
    """Restore ``<ckpt>/best`` for serving on ``device``: folded first if
    asked (in float32; the unet only), then bfloat16 and channels-last on
    CUDA, float32 on the CPU.

    ``best/model.pt`` (the port's format) rebuilds the saved model, which
    must be of the family ``arch``; for a unet ``s2d`` overrides its stem
    (a mismatching weight layout raises). ``best/state.msgpack`` (the JAX
    package's) is loaded into ``cfg``'s model of the family ``arch``: a
    siamese as the zoo builds it; a unet with the stem ``s2d`` or, when
    None, the config's, and if the weights do not fit that stem it retries
    once with the stem flipped (an explicit ``s2d`` does not retry)."""
    if fold_bn and arch != "unet":
        raise ValueError("fold_bn supports the unet family only")
    best = os.path.join(ckpt_dir, "best")
    if os.path.exists(os.path.join(best, "state.msgpack")) and \
            not os.path.exists(os.path.join(best, "model.pt")):
        tree, meta = read_flax_checkpoint(best)
        if arch != "unet":
            model = load_flax_weights(build_empty(get_family(arch).build, cfg), tree)
        else:
            stem = bool(cfg.space_to_depth) if s2d is None else s2d

            def build(space_to_depth):
                return build_empty(UNet, len(cfg.bands), n_classes=cfg.num_classes,
                                   head="sigmoid" if cfg.num_classes == 1 else "softmax",
                                   threshold=cfg.threshold, space_to_depth=space_to_depth)

            try:
                model = load_flax_weights(build(stem), tree)
            except (KeyError, RuntimeError):
                if s2d is not None:
                    raise
                model = load_flax_weights(build(not stem), tree)
                print(f"note: checkpoint stem differs from the config default — "
                      f"serving space_to_depth={not stem}")
    else:
        model, meta = load_checkpoint(
            ckpt_dir, **({} if s2d is None or arch != "unet" else {"space_to_depth": s2d}))
        if arch_of(model) != arch:
            raise ValueError(f"{ckpt_dir} holds a {arch_of(model)} model, not a {arch}")
    print(f"restored checkpoint (meta: {json.dumps(meta)})")
    if fold_bn:
        model = fold_unet(model)
    if device.type == "cuda":
        return model.to(device=device, dtype=torch.bfloat16,
                        memory_format=torch.channels_last)
    return model.to(device)


def _uint8(probs: torch.Tensor) -> torch.Tensor:
    """Probabilities x255 as uint8 (``--uint8``)."""
    return (probs * 255.0).to(torch.uint8)


def _change(args, cfg, model, device, comp_kw):
    """Change mode: the before and after scenes ride one engine pass as a
    2C-band stack; each chip batch is split back at C into the Siamese
    model's two inputs. Culling (``--nodata``, by default the before
    scene's tag) drops a chip only where both scenes are nodata."""
    before, meta = load_scene(args.input_before)
    after, _ = load_scene(args.input_after)
    if before.shape != after.shape:
        sys.exit(f"scene shapes differ: {before.shape} vs {after.shape}")
    nb = before.shape[-1]
    stack = np.concatenate([before, after], axis=-1)

    def predict_pair(chips):
        return model(chips[..., :nb], chips[..., nb:])["probs"]

    kernel, buffer, batch, tile_mode, source = resolve_serving_geometry(cfg, args, args.ckpt,
                                                                        device)
    print(f"serving geometry: k{kernel}+b{buffer} batch {batch} tile_mode={tile_mode} "
          f"({source}) on {device}")
    nodata = args.nodata if args.nodata is not None else meta.get("nodata")
    engine = TiledInferenceEngine(
        predict_pair, kernel=kernel, buffer=buffer, batch_size=batch, out_channels=1,
        blend=args.blend, tile_mode=tile_mode, max_rows=args.max_rows, nodata=nodata,
        output_transform=_uint8 if args.uint8 else None, device=device)
    h, w = stack.shape[:2]
    t0 = time.perf_counter()
    pred = engine.predict_scene(stack).cpu().numpy()
    out = args.output or "change.tif"
    (write_cog if args.cog else write_geotiff)(
        out, pred, transform=tuple(args.transform) if args.transform else meta.get("transform"),
        crs=args.crs or meta.get("crs", ""), **comp_kw)
    dt = time.perf_counter() - t0
    print(f"wrote {out} shape={pred.shape} ({dt:.3f} s incl. write, "
          f"{h * w / 1e6 / dt:.2f} MPix/s of scene pairs)")
    return out


def _sweep_paths(args):
    if os.path.isdir(args.input):
        paths = sorted(p for p in glob.glob(os.path.join(args.input, "*"))
                       if p.endswith((".npy", ".tif", ".tiff")))
    else:
        paths = sorted(glob.glob(args.input))
    if args.shard_count < 1 or not (0 <= args.shard_index < args.shard_count):
        sys.exit(f"--shard-index {args.shard_index} must be in "
                 f"[0, --shard-count {args.shard_count}) — indices are "
                 "0-based; overlapping shards would double-predict files")
    if args.shard_count > 1:
        paths = paths[args.shard_index :: args.shard_count]
    if not paths:
        sys.exit(f"no scenes match {args.input!r}"
                 + (f" for shard {args.shard_index}/{args.shard_count}"
                    if args.shard_count > 1 else ""))
    return paths


def _sweep(args, cfg, engine_kw, comp_kw):
    """Sweep mode: one engine over many scenes, one GeoTIFF each."""
    paths = _sweep_paths(args)
    # the engine culls with ONE nodata value; honor the inputs' GDAL_NODATA
    # tags when --nodata is absent, refusing mixed tags
    nodata = args.nodata
    if nodata is None:
        values = {GeoTiffScene(p).nodata for p in paths if p.endswith((".tif", ".tiff"))}
        values.discard(None)
        if len(values) > 1:
            sys.exit(f"mixed GDAL_NODATA tags across the sweep ({sorted(values)}); "
                     "pass an explicit --nodata")
        if values:
            nodata = values.pop()
            print(f"nodata={nodata} (from the inputs' GDAL_NODATA tags)")
    if args.bucket and args.max_rows is not None:
        print("note: --bucket is a no-op with --max-rows — banded bands already "
              "pad to chip-grid multiples")
    outdir = args.outdir or "predictions"
    os.makedirs(outdir, exist_ok=True)
    engine = TiledInferenceEngine(nodata=nodata, **engine_kw)
    print(f"sweep: {len(paths)} scenes, geometry k{engine.kernel}+b{engine.buffer} "
          f"batch {engine.batch_size} tile_mode={engine.tile_mode} on {engine.device}")

    # same-stem inputs of different formats (de.npy + de.tif) must not
    # collide on one output: those keep their extension in the name
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    dup_stems = {s for s in stems if stems.count(s) > 1}

    def out_path(p):
        stem, ext = os.path.splitext(os.path.basename(p))
        if stem in dup_stems:
            stem = f"{stem}_{ext.lstrip('.')}"
        return os.path.join(outdir, f"{stem}_pred.tif")

    def geo_kwargs(meta):
        return dict(transform=tuple(args.transform) if args.transform else meta.get("transform"),
                    crs=args.crs or meta.get("crs", ""))

    t0 = time.monotonic()
    mpix = 0.0
    written = []
    write = write_cog if args.cog else write_geotiff
    if args.max_rows is not None:
        # swath-scale sweep: per-scene banded disk-to-disk streaming
        # (predict_scenes would stage whole scenes on the device)
        for p in paths:
            scene, meta = load_scene(p, args.max_rows)
            out = out_path(p)
            kw = geo_kwargs(meta)
            if scene.shape[0] <= args.max_rows:
                write(out, engine.predict_scene(scene).cpu().numpy(), **kw, **comp_kw)
            else:
                engine.predict_scene_to_geotiff(scene, out, cog=args.cog, **kw, **comp_kw)
            h, w = scene.shape[:2]
            mpix += h * w / 1e6
            written.append(out)
            print(f"  {out} shape={(h, w, cfg.num_classes)}")
    else:
        metas = []  # (meta, original (h, w)), appended before each yield

        def scenes():
            for p in paths:
                scene, meta = load_scene(p)
                metas.append((meta, scene.shape[:2]))
                if args.bucket:
                    b = args.bucket
                    ph, pw = -scene.shape[0] % b, -scene.shape[1] % b
                    if ph or pw:
                        scene = np.pad(scene, ((0, ph), (0, pw), (0, 0)), mode="edge")
                yield scene

        for path, pred in zip(paths, engine.predict_scenes(scenes(), prefetch=args.prefetch,
                                                           readback=True)):
            meta, (h, w) = metas.pop(0)
            pred = pred[:h, :w]
            out = out_path(path)
            write(out, pred, **geo_kwargs(meta), **comp_kw)
            mpix += h * w / 1e6
            written.append(out)
            print(f"  {out} shape={pred.shape}")
    dt = time.monotonic() - t0
    print(f"swept {len(written)} scenes ({mpix:.1f} MPix) in {dt:.1f}s "
          f"({mpix / max(dt, 1e-9):.2f} MPix/s end-to-end)")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["scene", "change", "sweep", "patches"])
    ap.add_argument("--input", help="scene .npy or GeoTIFF; sweep: a directory or glob "
                    "of .npy/.tif scenes; patches: an export directory or glob")
    ap.add_argument("--input-before", help="change mode: the before scene (.npy or GeoTIFF)")
    ap.add_argument("--input-after", help="change mode: the after scene, of the same shape")
    ap.add_argument("--ckpt", required=True, help="checkpoint directory (reads <ckpt>/best)")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="solar")
    ap.add_argument("--model", choices=["unet", "deeplab", "siamese"], default=None,
                    help="model family (default: the config's)")
    ap.add_argument("--output", help="scene/change mode: output .tif path (default "
                    "prediction.tif / change.tif)")
    ap.add_argument("--outdir", help="sweep/patches mode: output directory")
    ap.add_argument("--base", default="pred", help="patches mode: output basename")
    ap.add_argument("--kernel", type=int, default=None,
                    help="engine chip kernel (default: the config's serving kernel)")
    ap.add_argument("--buffer", type=int, default=None,
                    help="engine chip context buffer (default: the config's)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="chips per forward (default: the config's serving batch)")
    ap.add_argument("--tune", action="store_true",
                    help="scene mode: time the candidate chip geometries on the device, "
                    "serve the fastest and keep the table in <ckpt>/tune_torch.json "
                    "(later serves use it); overrides --kernel/--buffer/--tile-mode; "
                    "with --max-rows a tall scene tunes on one band")
    ap.add_argument("--blend", choices=["overwrite", "hann"], default="hann")
    ap.add_argument("--tile-mode", choices=["chips", "whole"], default="chips",
                    help="whole = one fully convolutional forward over the padded "
                    "scene (no tile seams; the scene must fit on the device)")
    ap.add_argument("--max-rows", type=int, default=None,
                    help="stream scenes taller than this in full-width bands "
                    "(bounds device memory; both tile modes)")
    ap.add_argument("--nodata", type=float, default=None,
                    help="cull chips whose full window is this value in every band "
                    "(accepts 'nan'); exact on valid pixels. Defaults to the input "
                    "GeoTIFF's nodata tag (change: the before scene's); chips tile "
                    "mode only")
    ap.add_argument("--cog", action="store_true", help="write a Cloud-Optimized GeoTIFF")
    ap.add_argument("--compress", choices=["none", "deflate", "lzw"], default="deflate",
                    help="output compression; lzw (+ --predictor 2) is GDAL's common "
                    "COG recipe")
    ap.add_argument("--predictor", type=int, choices=[1, 2, 3], default=1,
                    help="TIFF predictor: 2 = integer horizontal differencing (with "
                    "--uint8), 3 = float byte-plane differencing (probabilities)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="sweep mode: scenes staged ahead on the device")
    ap.add_argument("--shard-index", type=int, default=0,
                    help="sweep mode: this worker's index (workers take files "
                    "round-robin)")
    ap.add_argument("--shard-count", type=int, default=1,
                    help="sweep mode: total workers")
    ap.add_argument("--bucket", type=int, default=None,
                    help="sweep mode: pad each scene's H/W up to the next multiple of "
                    "this (edge-replicated), then crop the prediction back. Exact for "
                    "blend=overwrite; hann values within ~kernel of a padded edge can "
                    "shift")
    ap.add_argument("--fold-bn", action="store_true",
                    help="serve the BN-folded model (no BN ops; same math as eval-mode BN)")
    ap.add_argument("--uint8", action="store_true", help="write probabilities x255 as uint8")
    ap.add_argument("--s2d", action=argparse.BooleanOptionalAction, default=None,
                    help="the checkpoint's stem (default: as saved in model.pt, or the "
                    "config's for state.msgpack, retrying the other stem on a mismatch)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--crs", default="")
    ap.add_argument("--transform", type=float, nargs=6,
                    help="affine: xscale xshear xtrans yshear yscale ytrans")
    args = ap.parse_args(argv)

    # predictor/dtype compatibility is known at parse time (the output dtype
    # is --uint8's choice): fail here, not after the inference
    if args.predictor == 2 and not args.uint8:
        ap.error("--predictor 2 (integer differencing) needs --uint8 output; use "
                 "--predictor 3 for float probabilities")
    if args.predictor == 3 and args.uint8:
        ap.error("--predictor 3 (float byte-plane differencing) applies to float "
                 "output; use --predictor 2 with --uint8")
    cfg = CONFIGS[args.config]
    arch = args.model or ("siamese" if cfg.family == "siamese" else "unet")
    if args.fold_bn and arch != "unet":
        sys.exit("--fold-bn currently supports the unet family only")
    if (args.mode == "change") != (arch == "siamese"):
        sys.exit(f"{args.mode} mode serves the "
                 f"{'siamese' if args.mode == 'change' else 'unet or deeplab'} family, "
                 f"not {arch}")
    if args.mode == "change":
        if not (args.input_before and args.input_after):
            sys.exit("change mode needs --input-before and --input-after")
    elif not args.input:
        sys.exit("--input is required")
    comp_kw = dict(compress=args.compress, predictor=args.predictor)
    device = resolve_device(args.device)
    model = load_model(args.ckpt, device, args.s2d, args.fold_bn, cfg, arch)
    if args.mode == "change":
        return _change(args, cfg, model, device, comp_kw)

    def predict(chips):
        return model(chips)["probs"]

    if args.mode == "patches":
        files, mixer_path = list_export_files(args.input)
        if not files:
            sys.exit(f"no tfrecords under {args.input!r}")
        written = run_batch_prediction(
            args.input, predict, list(cfg.bands), out_dir=args.outdir or "predictions",
            out_base=args.base, kernel_shape=(cfg.kernel_size, cfg.kernel_size),
            kernel_buffer=(cfg.kernel_buffer, cfg.kernel_buffer),
            batch_size=args.batch_size or cfg.serving_geometry[2], device=device)
        print(f"wrote {len(written)} prediction tfrecords")
        if mixer_path:
            mixer = read_mixer(mixer_path)
            print(f"mixer: {mixer.total_patches} patches, upload with: earthengine upload "
                  f"image --asset_id=<id> {' '.join(written)} {mixer_path}")
        return written

    # S2D halves the grid before the trunk: whole-scene padding covers one
    # more factor of 2
    whole_multiple = 64 if getattr(model, "space_to_depth", False) else 32
    output_transform = _uint8 if args.uint8 else None
    if args.mode == "scene" and args.tune:
        scene, meta = load_scene(args.input, args.max_rows)
        nodata = args.nodata if args.nodata is not None else meta.get("nodata")
        engine = _tune(args, cfg, predict, scene, whole_multiple, output_transform, device)
        # tuning times full grids; serving still culls
        engine.nodata = nodata
        return _serve_scene(args, engine, scene, meta, nodata, comp_kw)

    kernel, buffer, batch, tile_mode, source = resolve_serving_geometry(cfg, args, args.ckpt,
                                                                        device)
    engine_kw = dict(
        predict_fn=predict, kernel=kernel, buffer=buffer, batch_size=batch,
        out_channels=cfg.num_classes, blend=args.blend, tile_mode=tile_mode,
        max_rows=args.max_rows, device=device, whole_multiple=whole_multiple,
        output_transform=output_transform,
    )
    print(f"serving geometry: k{kernel}+b{buffer} batch {batch} tile_mode={tile_mode} "
          f"({source}) on {device}")
    if args.mode == "sweep":
        return _sweep(args, cfg, engine_kw, comp_kw)

    scene, meta = load_scene(args.input, args.max_rows)
    nodata = args.nodata if args.nodata is not None else meta.get("nodata")
    engine = TiledInferenceEngine(nodata=nodata, **engine_kw)
    return _serve_scene(args, engine, scene, meta, nodata, comp_kw)


def _tune(args, cfg, predict, scene, whole_multiple, output_transform, device):
    """``scene --tune``: time the candidate geometries on ``device`` (one
    band of a scene taller than ``--max-rows``), write the table to
    ``<ckpt>/tune_torch.json`` and return the fastest engine."""
    print(f"tuning chip geometry on {device_name(device)}:")
    engine, rows = tune_engine_geometry(
        predict, scene.shape, np.float32, out_channels=cfg.num_classes, blend=args.blend,
        batch_size=args.batch_size or cfg.serving_geometry[2],
        output_transform=output_transform, chip_multiple=whole_multiple, scene=scene,
        max_rows=args.max_rows, verbose=print, device=device)
    table = os.path.join(args.ckpt, TUNE_TABLE)
    save_tune_table(table, rows)
    print(f"serving with {rows[0].label()} ({rows[0].ms:.1f} ms/scene); table cached at "
          f"{table} (later serves on this device use it)")
    print(f"serving geometry: k{engine.kernel}+b{engine.buffer} batch {engine.batch_size} "
          f"tile_mode={engine.tile_mode} (tuned) on {device}")
    return engine


def _serve_scene(args, engine, scene, meta, nodata, comp_kw):
    """Scene mode's serve and write: streamed banded when the scene is
    taller than the engine's ``max_rows``, else one pass (chips culled
    with ``nodata``) and one write."""
    out = args.output or "prediction.tif"
    out_tf = tuple(args.transform) if args.transform else meta.get("transform")
    out_crs = args.crs or meta.get("crs", "")
    h, w = scene.shape[:2]
    t0 = time.perf_counter()
    if engine.max_rows is not None and h > engine.max_rows:
        # disk-to-disk streaming: output rows reach the GeoTIFF as each band
        # completes (--cog streams tiles + overviews at the same bound)
        engine.predict_scene_to_geotiff(scene, out, transform=out_tf, crs=out_crs,
                                        cog=args.cog, **comp_kw)
        how = f"streamed banded{', cog' if args.cog else ''}"
    else:
        valid = None
        if nodata is not None and engine.tile_mode == "chips":
            valid = engine.chip_validity(scene)
            print(f"nodata={nodata}: {int(valid.sum())}/{len(valid)} chips carry valid "
                  f"pixels; culling the rest")
        pred = engine.predict_scene(scene, valid_chips=valid).cpu().numpy()
        (write_cog if args.cog else write_geotiff)(
            out, pred, transform=out_tf, crs=out_crs, **comp_kw)
        how = "cog" if args.cog else "geotiff"
    dt = time.perf_counter() - t0
    print(f"wrote {out} ({how}) shape={(h, w, engine.out_channels)} "
          f"({dt:.3f} s incl. write, {h * w / 1e6 / dt:.2f} MPix/s)")
    return out


if __name__ == "__main__":
    main()
