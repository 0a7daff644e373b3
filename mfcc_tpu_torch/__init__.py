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
    pipeline     host batching into flat int16/float rows
"""

from mfcc_tpu_torch.config import (FrontendConfig, config_with_overrides,
                                   named_config, NAMED_CONFIGS)

__version__ = "0.1.0"


def extract(samples, config="classic13", device="cuda"):
    """One utterance's samples (int16 or float array/tensor at
    cfg.input_sample_rate when it is set, else cfg.sample_rate) → [F_valid,
    feat_dim] features on `device` (`chain.extract_single`).

    Wav paths and bytes need the io port (ROADMAP queue 1 item 4) and
    raise NotImplementedError."""
    from mfcc_tpu_torch.ops import chain

    if isinstance(samples, (str, bytes)) or hasattr(samples, "__fspath__"):
        raise NotImplementedError(
            "wav input needs the io port (ROADMAP queue 1 item 4); pass the "
            "decoded samples"
        )
    cfg = named_config(config) if isinstance(config, str) else config
    return chain.extract_single(samples, cfg, device=device)


__all__ = [
    "FrontendConfig", "config_with_overrides", "named_config",
    "NAMED_CONFIGS", "extract", "__version__",
]
