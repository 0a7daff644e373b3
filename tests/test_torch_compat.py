"""The port's compat surface (`mfcc_tpu_torch.compat`, float64 numpy over its
own `ops/reference_numpy.py` and `ops/constants.py`) ≡ the JAX package's
`mfcc_tpu.compat`, bit for bit, on the same inputs made from a numpy seed:
every feature function and sigproc helper, at its defaults and with
non-default arguments; `as_config` and `as_kaldi_config` give the same
fields and `config_hash`, and refuse the same arguments. The port's oracle
copy is held bitwise to the reference's on every named config that does not
resample; a config from `as_config` runs through the port's chain within
the cepstra gate of the compat `mfcc`.
"""

import dataclasses

import numpy as np
import pytest

from mfcc_tpu import compat as jcompat
from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import reference_numpy as jref
from mfcc_tpu_torch import compat
from mfcc_tpu_torch.config import NAMED_CONFIGS
from mfcc_tpu_torch.ops import chain
from mfcc_tpu_torch.ops import reference_numpy as ref

G = np.random.default_rng(29)
SIG = G.standard_normal(8000) * 3000.0
SIG22 = G.standard_normal(11025) * 3000.0


def _equal(a, b) -> None:
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


FEATURE_CALLS = [
    ("mfcc", (SIG,), {}),
    ("mfcc", (SIG,), {"winfunc": np.hamming}),
    ("mfcc", (SIG,), {"winfunc": np.hamming, "appendEnergy": False, "ceplifter": 0}),
    ("mfcc", (SIG22,), {"samplerate": 22050, "nfft": 1024, "numcep": 20, "nfilt": 40, "lowfreq": 100,
                        "highfreq": 8000, "preemph": 0.9}),
    ("fbank", (SIG,), {"winfunc": np.hamming}),
    ("fbank", (SIG,), {"nfilt": 40, "winlen": 0.032, "winstep": 0.016}),
    ("logfbank", (SIG,), {"winfunc": np.hanning}),
    ("ssc", (SIG,), {"winfunc": np.hamming}),
    ("ssc", (SIG,), {"preemph": 0.0, "nfilt": 20}),
]


@pytest.mark.parametrize("fn,args,kw", FEATURE_CALLS, ids=[f"{c[0]}{i}" for i, c in enumerate(FEATURE_CALLS)])
def test_feature_functions_bitwise(fn, args, kw):
    _equal(getattr(compat, fn)(*args, **kw), getattr(jcompat, fn)(*args, **kw))


def test_sigproc_helpers_bitwise():
    frames = compat.framesig(SIG, 400, 160, np.hamming)
    _equal(frames, jcompat.framesig(SIG, 400, 160, np.hamming))
    _equal(compat.framesig(SIG, 400.2, 159.8), jcompat.framesig(SIG, 400.2, 159.8))
    for winfunc in (compat._ones, np.hamming):
        f = compat.framesig(SIG, 400, 160, winfunc)
        _equal(compat.deframesig(f, len(SIG), 400, 160, winfunc), jcompat.deframesig(f, len(SIG), 400, 160, winfunc))
        _equal(compat.deframesig(f, 0, 400, 160, winfunc), jcompat.deframesig(f, 0, 400, 160, winfunc))
    for fn in ("magspec", "powspec"):
        _equal(getattr(compat, fn)(frames, 512), getattr(jcompat, fn)(frames, 512))
    for norm in (0, 1):
        _equal(compat.logpowspec(frames, 512, norm=norm), jcompat.logpowspec(frames, 512, norm=norm))
    _equal(compat.preemphasis(SIG), jcompat.preemphasis(SIG))
    _equal(compat.preemphasis(SIG, 0.97), jcompat.preemphasis(SIG, 0.97))
    feat = compat.mfcc(SIG)
    for n in (1, 2, 3):
        _equal(compat.delta(feat, n), jcompat.delta(feat, n))
    for lift in (22, 0, -1):
        _equal(compat.lifter(feat, lift), jcompat.lifter(feat, lift))
    with pytest.raises(ValueError):
        compat.delta(feat, 0)


def test_mel_scale_and_filterbanks_bitwise():
    f = np.linspace(0, 8000, 101)
    _equal(compat.hz2mel(f), jcompat.hz2mel(f))
    _equal(compat.mel2hz(compat.hz2mel(f)), jcompat.mel2hz(jcompat.hz2mel(f)))
    for args in [(26, 512, 16000), (40, 1024, 22050, 100, 8000), (20, 512, 8000, 0, None)]:
        _equal(compat.get_filterbanks(*args), jcompat.get_filterbanks(*args))


def _same_config(a, b) -> None:
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.config_hash() == b.config_hash()


@pytest.mark.parametrize("kw", [
    {},
    {"winfunc": np.hamming},
    {"winfunc": np.hanning, "numcep": 20, "nfilt": 40, "deltas": 2, "cmvn": "utterance"},
    {"samplerate": 22050, "nfft": 1024, "lowfreq": 100, "highfreq": 8000, "winfunc": np.blackman},
    {"features": "logmel", "appendEnergy": False, "ceplifter": 0},
])
def test_as_config_same_fields_and_hash(kw):
    _same_config(compat.as_config(**kw), jcompat.as_config(**kw))


@pytest.mark.parametrize("ft,kw", [
    ("mfcc", {}),
    ("mfcc", {"dither": 0.0, "window_type": "hamming", "snip_edges": False, "num_ceps": 20,
              "high_freq": -400.0, "subtract_mean": True, "deltas": 2}),
    ("mfcc", {"sample_frequency": 11025.0, "raw_energy": False, "energy_floor": 1.0}),
    ("fbank", {"use_energy": False, "num_mel_bins": 80, "round_to_power_of_two": False}),
    ("plp", {"dither": 0.0, "vtln_warp": 1.1}),
])
def test_as_kaldi_config_same_fields_and_hash(ft, kw):
    _same_config(compat.as_kaldi_config(ft, **kw), jcompat.as_kaldi_config(ft, **kw))


@pytest.mark.parametrize("call", [
    lambda m: m.as_config(winfunc=np.bartlett),
    lambda m: m.as_kaldi_config("mfcc", htk_compat=True),
    lambda m: m.as_kaldi_config("mfcc", window_type="kaiser"),
    lambda m: m.as_kaldi_config("mfcc", channel=3),
    lambda m: m.as_kaldi_config("fbank", use_energy=True),
    lambda m: m.as_kaldi_config("pitch"),
])
def test_refusals_are_the_same(call):
    with pytest.raises(ValueError) as want:
        call(jcompat)
    with pytest.raises(ValueError) as got:
        call(compat)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", [n for n, c in J_CONFIGS.items()
                                  if not (c.input_sample_rate and c.input_sample_rate != c.sample_rate)])
def test_oracle_copy_bitwise(name):
    x = G.standard_normal(6000) * 3000.0
    _equal(ref.extract(x, NAMED_CONFIGS[name]), jref.extract(x, J_CONFIGS[name]))
    got, want = ref.extract_stages(x, NAMED_CONFIGS[name]), jref.extract_stages(x, J_CONFIGS[name])
    assert got.keys() == want.keys()
    for k in got:
        _equal(got[k], want[k])


def test_as_config_runs_on_the_port_chain():
    """A compat call site moved to the batched path: `as_config(winfunc=
    np.hamming)` through the port's chain gives the compat mfcc's
    features within the cepstra gate."""
    cfg = compat.as_config(winfunc=np.hamming)
    got = chain.extract_single(SIG, cfg, device="cpu").numpy()
    want = compat.mfcc(SIG, winfunc=np.hamming)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
