"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers."""


def launches() -> int:
    """Launches of every hand-written kernel so far in this process (each
    wrapper counts its own)."""
    from satellite_computervision_tpu_torch.kernels import epilogue, preprocess, stitch

    return (epilogue.launches() + preprocess.fused_preprocess.launches
            + stitch.hann_stitch.launches)
