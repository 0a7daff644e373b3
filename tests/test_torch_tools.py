"""The port's tools, on the CPU, against the JAX package:

- `cli convert` to HTK and to Kaldi writes the same bytes as the JAX
  package's `convert` on the same npz shards (with `--set` overrides, the
  stats npz in the shard directory skipped), resumes by its markers, and
  exits 2 on a shard whose feature dimension is not the config's;
- `cli info` prints the versions, the process and every named config with
  the JAX package's `config_hash`; `info --self-test --device cpu` passes
  against the float64 oracle, and `--device cuda` without a card exits 2;
- `cli plot` and `viz` write the 4-panel PNG (the chain's spectrogram and
  features on the CPU, the port's `logmel_single` / `extract_single`
  within the gates of the JAX package's), exit 2 without matplotlib;
- `utils.trace.stage_times` gives its four non-negative keys on the CPU.
"""

import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from mfcc_tpu.cli import main as jmain
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.testing.golden import golden_signals
from mfcc_tpu_torch import viz
from mfcc_tpu_torch.cli import main as tmain
from mfcc_tpu_torch.config import NAMED_CONFIGS, named_config
from mfcc_tpu_torch.io import ShardWriter, write_wav
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.utils.trace import stage_times


@pytest.fixture()
def shards(tmp_path):
    """Three npz shards of classic13_deltas with n_mels 40 (features of
    3-40 frames, 39 wide) and a CMVN stats npz beside them."""
    cfg = named_config("classic13_deltas").replace(n_mels=40)
    g = np.random.default_rng(5)
    w = ShardWriter(tmp_path / "npz", cfg)
    for s in range(3):
        ids = [f"/corpus/s{s}/utt{u}.wav" for u in range(4)]
        w.write(f"h0-{s:06d}", ids, [g.standard_normal((3 + 9 * u, 39)).astype(np.float32) for u in range(4)])
    np.savez(tmp_path / "npz" / "cmvn_moments_h0.npz", s1=np.zeros(39), s2=np.ones(39), n=np.float64(3))
    return tmp_path / "npz"


def _outputs(d: pathlib.Path) -> dict:
    """Every output file's bytes (a Kaldi scp's absolute ark paths with the
    output directory cut), the done markers (which hold a write time) read
    as their fields but that time."""
    out = {}
    for p in sorted(d.rglob("*")):
        if p.is_file():
            if p.parent.name == "done":
                meta = json.loads(p.read_text())
                meta.pop("written_at")
                out[p.relative_to(d).as_posix()] = meta
            else:
                out[p.relative_to(d).as_posix()] = p.read_bytes().replace(str(d).encode(), b"<out>")
    return out


@pytest.mark.parametrize("to", ["htk", "kaldi"])
def test_convert_writes_the_reference_bytes(shards, tmp_path, to):
    conf = ["--config", "classic13_deltas", "--set", "n_mels=40"]
    assert tmain(["convert", str(shards), "-o", str(tmp_path / "port"), "--to", to, *conf]) == 0
    assert jmain(["convert", str(shards), "-o", str(tmp_path / "jax"), "--to", to, *conf]) == 0
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert got == want
    assert len([k for k in got if not k.startswith("done/")]) == (12 if to == "htk" else 6)
    # a rerun skips every shard by its marker
    before = {p: p.stat().st_mtime_ns for p in (tmp_path / "port").rglob("*") if p.is_file()}
    assert tmain(["convert", str(shards), "-o", str(tmp_path / "port"), "--to", to, *conf]) == 0
    assert {p: p.stat().st_mtime_ns for p in (tmp_path / "port").rglob("*") if p.is_file()} == before


def test_convert_refusals(shards, tmp_path, caplog):
    rc = tmain(["convert", str(shards), "-o", str(tmp_path / "o"), "--to", "htk", "--config", "classic13"])
    assert rc == 2 and "feat dim 39 != config classic13's 13" in caplog.text
    assert tmain(["convert", str(tmp_path / "nothing"), "-o", str(tmp_path / "o2"), "--to", "kaldi"]) == 2


def test_info_prints_configs_with_the_reference_hashes(capsys):
    assert tmain(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out and "process 0/1" in out
    for name, cfg in J_CONFIGS.items():
        assert f"hash={cfg.config_hash()}" in out
        assert f"  {name:24s} " in out
    assert len(NAMED_CONFIGS) == len(J_CONFIGS)


def test_info_self_test_on_the_cpu(capsys):
    assert tmain(["info", "--self-test", "--device", "cpu"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("self-test")]
    assert lines[-1] == "self-test: PASS"
    assert len(lines) == 3 and all(" ok " in line for line in lines[:2])
    errs = [float(line.split("max|err|=")[1].split()[0]) for line in lines[:2]]
    assert max(errs) < importlib.import_module("mfcc_tpu_torch.cli.main").SELF_TEST_GATE == 2e-3


def test_info_self_test_on_cuda_without_a_card_exits_2(caplog):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the self-test runs there (tests/test_torch_gpu.py)")
    assert tmain(["info", "--self-test"]) == 2
    assert "no CUDA device" in caplog.text


def test_plot_command_and_viz_panels(tmp_path):
    cfg = NAMED_CONFIGS["classic13"]
    sig = golden_signals()["speechish"]
    write_wav(tmp_path / "a.wav", 16000, np.round(sig * 3000).astype(np.int16))
    (tmp_path / "bad.wav").write_bytes(b"RIFF not a wav")
    assert tmain(["plot", str(tmp_path / "a.wav"), "-o", str(tmp_path / "png"), "--device", "cpu"]) == 0
    assert (tmp_path / "png" / "a.png").stat().st_size > 10_000
    assert tmain(["plot", str(tmp_path / "bad.wav"), "-o", str(tmp_path / "png"), "--device", "cpu"]) == 1
    fig = viz.plot_all(sig, cfg, tmp_path / "summary.png", device="cpu")
    assert (tmp_path / "summary.png").stat().st_size > 10_000 and len(fig.axes) >= 4
    # the panels' data: the port's chain, within the gates of the JAX package's
    st = chain.logmel_single(sig, cfg, device="cpu")
    jst = jchain.logmel_single(sig, J_CONFIGS["classic13"])
    np.testing.assert_allclose(st["logmel"].numpy(), jst["logmel"], atol=1e-4)
    np.testing.assert_allclose(chain.extract_single(sig, cfg, device="cpu").numpy(),
                               jchain.extract_single(sig, J_CONFIGS["classic13"]), atol=5e-4)
    assert viz.plot_filterbank(NAMED_CONFIGS["logmel80"]) is not None
    assert viz.plot_features(torch.randn(50, 80), NAMED_CONFIGS["logmel80"]) is not None
    import matplotlib.pyplot as plt

    plt.close("all")


def test_plot_without_matplotlib_exits_2(tmp_path, monkeypatch, caplog):
    def missing():
        raise ImportError("mfcc_tpu_torch.viz draws with matplotlib, which is not installed")

    monkeypatch.setattr(viz, "_plt", missing)
    write_wav(tmp_path / "a.wav", 16000, np.zeros(4000, np.int16))
    assert tmain(["plot", str(tmp_path / "a.wav"), "-o", str(tmp_path / "png"), "--device", "cpu"]) == 2
    assert "matplotlib" in caplog.text and not (tmp_path / "png").exists()
    if not torch.cuda.is_available():  # the default device is the card
        monkeypatch.undo()
        assert tmain(["plot", str(tmp_path / "a.wav"), "-o", str(tmp_path / "png")]) == 2


@pytest.mark.parametrize("name", ["classic13_deltas", "mfcc39_48k"])
def test_stage_times_keys(name):
    cfg = named_config(name)
    sr = cfg.input_sample_rate or cfg.sample_rate
    g = np.random.default_rng(2)
    audio = torch.as_tensor(g.standard_normal((2, sr)) * 1000, dtype=torch.float32)
    t = stage_times(audio, [sr, sr // 2], cfg, device="cpu", reps=2)
    assert set(t) == {"preemph", "logmel", "full", "features_minus_logmel"}
    assert all(v >= 0 for v in t.values())
    assert t["features_minus_logmel"] == max(0.0, t["full"] - t["logmel"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage_times(audio, [sr, sr], cfg)
