"""Visualization: waveform, power spectrogram, mel filterbank shapes and
feature heatmaps. The port of `mfcc_tpu/viz.py`.

The panels' data come from the port's chain on the chosen device
(`chain.logmel_single` for the spectrogram, `chain.extract_single` for the
features; "cuda" by default) and are drawn on the host with matplotlib,
imported when a figure is drawn, with the Agg backend, so extraction never
needs it. Each function returns the Figure; `plot_all` writes a 4-panel
summary PNG for one utterance.
"""

from __future__ import annotations

import numpy as np

from mfcc_tpu_torch.config import FrontendConfig
from mfcc_tpu_torch.io import writer
from mfcc_tpu_torch.ops import constants as C


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "mfcc_tpu_torch.viz draws with matplotlib, which is not installed"
        ) from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    """A float64 host array of a numpy array or a tensor (on any device)."""
    return writer._host(x).astype(np.float64, copy=False)


def plot_waveform(x, cfg: FrontendConfig, ax=None):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 2.5))
    sr = cfg.input_sample_rate or cfg.sample_rate
    x = _host(x)
    ax.plot(np.arange(len(x)) / sr, x, linewidth=0.5)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("amplitude")
    ax.set_title("waveform")
    return ax.figure


def plot_spectrogram(pspec, cfg: FrontendConfig, ax=None, db_floor: float = -80.0):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 3.5))
    p = _host(pspec)
    db = 10.0 * np.log10(np.maximum(p, 1e-300))
    db = np.maximum(db - db.max(), db_floor)
    extent = [0, p.shape[0] * cfg.hop_s, 0, cfg.sample_rate / 2 / 1000.0]
    im = ax.imshow(db.T, origin="lower", aspect="auto", extent=extent, cmap="magma")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [kHz]")
    ax.set_title("power spectrogram [dB]")
    ax.figure.colorbar(im, ax=ax, pad=0.01)
    return ax.figure


def plot_filterbank(cfg: FrontendConfig, ax=None):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 2.5))
    fb = C.mel_filterbank(cfg)  # [n_bins, n_mels]
    freqs = np.linspace(0, cfg.sample_rate / 2, cfg.n_bins)
    for j in range(cfg.n_mels):
        ax.plot(freqs, fb[:, j], linewidth=0.8)
    ax.set_xlabel("frequency [Hz]")
    ax.set_ylabel("weight")
    ax.set_title(f"mel filterbank ({cfg.n_mels} {cfg.mel_variant} triangles)")
    return ax.figure


def plot_features(feat, cfg: FrontendConfig, ax=None):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 3.5))
    f = _host(feat)
    extent = [0, f.shape[0] * cfg.hop_s, 0, f.shape[1]]
    im = ax.imshow(f.T, origin="lower", aspect="auto", extent=extent, cmap="viridis")
    kind = {"mfcc": "MFCC", "plp": "PLP", "ssc": "SSC",
            "spectrogram": "log-spectrogram"}.get(cfg.features, "log-mel")
    ax.set_xlabel("time [s]")
    ax.set_ylabel(f"{kind} index")
    ax.set_title(f"{kind} features [{f.shape[1]}]")
    ax.figure.colorbar(im, ax=ax, pad=0.01)
    return ax.figure


def plot_all(x, cfg: FrontendConfig, out_path=None, device="cuda"):
    """4-panel summary: waveform / spectrogram / filterbank / features.

    x is at cfg.input_sample_rate; the waveform panel shows it as given,
    the spectrogram and the features are computed on `device` at the
    chain's rate (`logmel_single` and `extract_single` resample first)."""
    from mfcc_tpu_torch.ops import chain

    plt = _plt()
    x = _host(x)
    stages = chain.logmel_single(x, cfg, device=device)
    feat = chain.extract_single(x, cfg, device=device)
    fig, axes = plt.subplots(4, 1, figsize=(11, 12), constrained_layout=True)
    plot_waveform(x, cfg, axes[0])
    plot_spectrogram(stages["pspec"], cfg, axes[1])
    plot_filterbank(cfg, axes[2])
    plot_features(feat, cfg, axes[3])
    if out_path is not None:
        fig.savefig(out_path, dpi=110)
    return fig
