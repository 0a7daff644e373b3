"""mfcc_tpu_torch — the PyTorch/CUDA port of the mfcc_tpu front-end.

A package of its own beside `mfcc_tpu/` (the JAX reference, which it never
imports): the same module names, PyTorch idiom, and hand-written CUDA
kernels for Hopper in place of the Pallas TPU kernels. Entry points run on
the card ("cuda") unless the caller passes device="cpu", which runs the
plain torch chain.

Layers:
    config       frozen FrontendConfig + named configs (a copy of the JAX one)
    ops          constants (float64 host matrices, `to_torch`), the dither
                 noise contract, the polyphase resampler and the chain
    kernels      CUDA front-end, feature-tail and resample kernels, wrappers,
                 plain versions
    pipeline     host batching into flat int16/float rows (pinned for the
                 card), segment/stitch extraction of long utterances
    io           wav decode (C++ fast path), the threaded feed, shard
                 writers with resume markers, HTK and Kaldi output
    parallel     data parallelism over cards and processes, CMVN moments
    cli          `python -m mfcc_tpu_torch.cli extract` / `apply-cmvn`
"""

from mfcc_tpu_torch.config import (FrontendConfig, config_with_overrides,
                                   named_config, NAMED_CONFIGS)

__version__ = "0.1.0"


def extract(source, config="classic13", device="cuda"):
    """One-call convenience: wav path / wav bytes / samples (int16 or float
    array or tensor, at cfg.input_sample_rate when it is set, else
    cfg.sample_rate) → [F_valid, feat_dim] features on `device`.

    A wav at another rate raises ValueError. Audio over 60 s goes through
    `pipeline.extract_long` (segment/stitch, frame-exact); the rest through
    `chain.extract_single`. For batched extraction use
    `mfcc_tpu_torch.ops.chain.extract_batch` / `mfcc_tpu_torch.io` (or the
    CLI)."""
    from mfcc_tpu_torch.ops import chain

    cfg = named_config(config) if isinstance(config, str) else config
    expect_sr = cfg.input_sample_rate or cfg.sample_rate
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        from mfcc_tpu_torch.io import decode_wav_bytes, read_wav

        if isinstance(source, bytes):
            sr, samples = decode_wav_bytes(source)
        else:
            sr, samples = read_wav(source)
        if sr != expect_sr:
            raise ValueError(
                f"wav is {sr} Hz but config {cfg.config_hash()} expects "
                f"{expect_sr} Hz; pick a matching config or resample"
            )
    else:
        samples = source
    if samples.shape[0] > 60 * expect_sr:
        from mfcc_tpu_torch.pipeline import extract_long

        return extract_long(samples, cfg, device=device)
    return chain.extract_single(samples, cfg, device=device)


__all__ = [
    "FrontendConfig", "config_with_overrides", "named_config",
    "NAMED_CONFIGS", "extract", "__version__",
]
