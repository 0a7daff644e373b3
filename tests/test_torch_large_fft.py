"""The front-end kernel's block FFT plan and the n_fft sizes it brought into
the port ≡ the JAX package.

The JAX package runs every n_fft. The port took, through the warp plan (a
frame a warp, each warp two rows of its own), only the sizes whose rows fit
the block's shared memory, and the rest of them up to 2,500 through a
direct DFT. The block plan (`kernels/frontend.py::fft_layout`,
csrc/frontend.cu plan_block) transforms 4, 2 or 1 frames a block at once,
each through two rows of its group, with the tables staged or read from
device memory. Here, on the CPU:
- the port's CPU chain ≡ the JAX jnp chain and the float64 oracle at
  classic13_deltas n_fft 1102, 2501 and 4096 and at librosa's framing
  (logmel80 at 22.05 kHz, n_fft 2048, 2048-sample frames, hop 512, 128
  mels), at each family's gate;
- the plans, layouts and refusals the layout mirror gives.
The kernel's numpy mirror with the block plan is in
tests/test_torch_frontend.py (`_emulate_kernel`); tests/test_torch_gpu.py and
chip_smoke.py hold the kernel to its plain version on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu.ops import reference_numpy as ref
from mfcc_tpu.pipeline import pad_batch as j_pad_batch
from mfcc_tpu_torch import testing
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.kernels import frontend
from mfcc_tpu_torch.ops import chain as tchain

# librosa's default framing (librosa.feature.melspectrogram: sr 22,050,
# n_fft 2048, win_length n_fft, hop 512, 128 mels) as a logmel80 override
LIBROSA = dict(sample_rate=22050, n_fft=2048, win_len_s=2048 / 22050, hop_s=512 / 22050, n_mels=128)
CASES = {
    "classic13_deltas_1102": ("classic13_deltas", dict(n_fft=1102)),
    "classic13_deltas_2501": ("classic13_deltas", dict(n_fft=2501)),
    "classic13_deltas_4096": ("classic13_deltas", dict(n_fft=4096)),
    "librosa_2048": ("logmel80", LIBROSA),
}


def _configs(case):
    name, over = CASES[case]
    return T_CONFIGS[name].replace(**over), J_CONFIGS[name].replace(**over)


def _rows(cfg, seed):
    """Three int16-valued rows of 1.0, 0.6 and 0.25 s at cfg's rate (zero
    past each length), as float32."""
    g = np.random.default_rng(seed)
    sr = cfg.sample_rate
    utts = [np.round(g.standard_normal(int(sr * s)) * 3000) for s in (1.0, 0.6, 0.25)]
    b = j_pad_batch(utts, cfg)
    return b.audio.astype(np.float32), b.lengths


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_jax_and_oracle(case):
    """The port's CPU chain (int16 rows) ≡ `extract_batch(backend="jnp")` of
    the JAX package and its float64 oracle (`reference_numpy.extract`, row by
    row) at the family's gate: 5e-4 on cepstra, the two-regime log-mel gate
    on librosa's 128 log-mel lanes; the masks equal. The kernel's layout fits
    the block in the block plan at each of these sizes."""
    tcfg, jcfg = _configs(case)
    assert tchain.unsupported_reason(tcfg) is None and frontend.fft_plan(tcfg) != "warp"
    x, lens = _rows(jcfg, seed=sum(map(ord, case)))
    feat, mask = tchain.extract_batch(x.astype(np.int16), lens, tcfg, device="cpu")
    jfeat, jmask = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="jnp")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    got, want = feat.numpy(), np.asarray(jfeat)
    assert got.shape == want.shape
    close = (testing.assert_features_close if tcfg.features == "mfcc"
             else lambda a, b: testing.assert_logmel_close(a, b, tcfg.log_kind))
    valid = mask.numpy() > 0
    close(got[valid], want[valid])
    for i, n in enumerate(lens):
        oracle = ref.extract(x[i, :n].astype(np.float64), jcfg)
        nv = int(valid[i].sum())
        assert oracle.shape[0] == nv
        close(got[i, :nv], oracle)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_on_cpu_launches_nothing(case):
    """On CPU tensors the wrapper at these sizes is its plain version, with
    no launch counted (the block plan's counts included)."""
    tcfg, jcfg = _configs(case)
    x, lens = _rows(jcfg, seed=3)
    before = (frontend.launches, frontend.block_fft_launches, frontend.global_table_launches)
    got = frontend.logmel_prefix(torch.as_tensor(x), torch.as_tensor(lens), tcfg)
    assert (frontend.launches, frontend.block_fft_launches, frontend.global_table_launches) == before
    np.testing.assert_array_equal(
        got.numpy(), frontend.logmel_prefix_reference(torch.as_tensor(x), torch.as_tensor(lens), tcfg).numpy())


def test_plans_and_layouts():
    """`fft_layout` (csrc/frontend.cu plan, plan_block) at 26 filters: the
    warp plan where each warp's two rows fit (683, the largest odd n_fft
    that does; 2048, 220,832 B), else the first of 4, 2 and 1 frames a
    block at once with the tables staged (1102: four, 168,080 B; 4096: two,
    198,144 B where the warp plan took 420,160 B), else with them in device
    memory (2501: two, 199,120 B; 5392: one, 195,584 B). librosa's framing,
    270,368 B in the warp plan, takes four frames a block at once in
    194,496 B. The fused resample has no block plan: at n_fft 1102
    mfcc39_48k takes the split route, whose plain form plans at 16 kHz."""
    c13 = T_CONFIGS["classic13"]
    want = {683: ("warp", 8, 214592), 2048: ("warp", 8, 220832), 1102: ("block", 4, 168080),
            4096: ("block", 2, 198144), 2501: ("block_global", 2, 199120),
            5392: ("block_global", 1, 195584)}
    for n_fft, (plan, groups, nbytes) in want.items():
        cfg = c13.replace(n_fft=n_fft)
        assert (*frontend.fft_layout(cfg), frontend.smem_bytes(cfg)) == (plan, groups, nbytes), n_fft
        assert frontend.smem_bytes(cfg, int16=False) == nbytes
    assert frontend._fft_smem(c13.replace(n_fft=4096), "stockham", "warp") == 420160
    lib = T_CONFIGS["logmel80"].replace(**LIBROSA)
    assert (lib.frame_length, lib.frame_step) == (2048, 512)
    assert frontend._fft_smem(lib, "stockham", "warp") == 270368
    assert (*frontend.fft_layout(lib), frontend.smem_bytes(lib)) == ("block", 4, 194496)
    assert frontend.chunk(frontend.packed_count(lib), 64) == -(-frontend.packed_count(lib) // 64) | 1
    fused = T_CONFIGS["mfcc39_48k"].replace(n_fft=1102)
    assert frontend.fft_plan(fused) == "warp" and frontend.resample_route(fused) == "split"
    assert frontend.fft_layout(frontend.feature_rate_config(fused)) == ("block", 4)
    assert tchain.unsupported_reason(fused) is None
    assert {frontend.dft_form(c13.replace(n_fft=n)) for n in (1102, 1103, 2047, 2501)} == {"bluestein"}
    # the layout mirror's packed count is the packing's own (`mel_packed`)
    for cfg in (c13.replace(n_fft=1102), c13.replace(n_fft=4096), lib, T_CONFIGS["ssc26"].replace(n_fft=2501)):
        mel = tchain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"]
        assert frontend.packed_count(cfg) == int(frontend.mel_packed(mel)[0][-1])


@pytest.mark.parametrize("over,plan", [
    (dict(n_fft=5392), "block_global"), (dict(n_fft=5393), "gather_global"),
    (dict(win_len_s=20640 / 16000), "block"), (dict(win_len_s=25376 / 16000), "block_global"),
    (dict(win_len_s=25377 / 16000), "gather"), (dict(n_mels=170, n_ceps=170, delta_window=8), "warp"),
    (dict(n_fft=7001), "gather_bands"), (dict(n_fft=16384, win_len_s=25377 / 16000), "gather_bands"),
], ids=["n_fft_5392", "n_fft_5393", "frame_1.29_s", "frame_25376", "frame_25377", "tail_170_cepstra",
        "n_fft_7001", "n_fft_16384"])
def test_what_is_still_refused(over, plan):
    """classic13_deltas: every n_fft to 5,392 and frames to 25,376 samples
    (1.29 s) take a layout of the block plan; n_fft 5,393 (the Bluestein
    rows of P = 8,192) and frames of 25,377 samples, refused before, take
    the gather plan, and the tail at 170 cepstra and delta window 8 its
    split plan. n_fft 7,001 (the Bluestein rows of P = 12,288) and 16,384
    with frames longer than n_fft (its packed mel bands), refused before,
    take the plan that reads the bands from device memory (16,384, an FFT
    of 8,192 points, takes the cluster plan before it), and their CPU
    chain ≡ the JAX jnp chain at the cepstra gate: nothing is refused."""
    cfg = T_CONFIGS["classic13_deltas"].replace(**over)
    assert tchain.unsupported_reason(cfg) is None
    assert frontend.fft_layout(cfg, cluster=False)[0] == plan
    assert frontend.fft_plan(cfg) == ("cluster" if cfg.n_fft == 16384 else plan)
    if plan == "gather_bands":
        jcfg = J_CONFIGS["classic13_deltas"].replace(**over)
        x, lens = _rows(jcfg, seed=cfg.n_fft)
        feat, mask = tchain.extract_batch(x.astype(np.int16), lens, cfg, device="cpu")
        jfeat, jmask = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="jnp")
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        testing.assert_features_close(feat.numpy(), np.asarray(jfeat))


def test_block_plan_sweep_applies_to_the_kernel_source():
    """scripts/block_plan_sweep.py moves the start of plan_block's search:
    its anchor is in csrc/frontend.cu once, and each variant differs from
    the source only there."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("block_plan_sweep", root / "scripts" / "block_plan_sweep.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = (root / "mfcc_tpu_torch" / "kernels" / "csrc" / "frontend.cu").read_text()
    assert src.count(sweep.SEARCH) == 1
    assert sweep.variant(src, (0, 4)) == src
    for start in sweep.STARTS[1:]:
        text = sweep.variant(src, start)
        assert text != src and text.replace(f"int plan = {start[0]}", "int plan = 0").replace(
            f"int groups = {start[1]}", "int groups = 4") == src
    c = T_CONFIGS["classic13"].replace(n_fft=1102)
    assert sweep.taken(frontend, c, (0, 4)) == ("block", 4, 168080, 1)
    assert sweep.taken(frontend, c, (1, 2))[:2] == ("block_global", 2)
    # the starts at the two new plans force them
    assert {start: sweep.taken(frontend, c, start)[:2] for start in sweep.STARTS[6:]} == {
        (4, 1): ("gather_bands", 1), (5, 4): ("gather_rows", 4)}
    assert [frontend.BLOCK_LADDER[start[0]] for _, start in sweep.FORCED] == [p for p, _ in sweep.FORCED]
