"""kaldi_spectrogram fed 8 kHz rows with "center" framing: the port and the
JAX package against the float64 chain.

After the 8 → 16 kHz resample the band above 4 kHz holds next to nothing,
and its log power is ill-conditioned in fp32: both packages sit over the
resampled rows' 8e-4 gate there (ROADMAP.md queue 3). On one seeded
4,000-sample row the port's CPU chain reads 1.89e-2 from the float64 chain
on its valid frames and the JAX package's jnp chain 3.51e-2. The test holds
the port no further from float64 than the JAX package, both under 5e-2 (the
larger measured error and a margin), and the masks equal.
"""

import numpy as np

import jax.numpy as jnp

from mfcc_tpu.config import NAMED_CONFIGS as J_CONFIGS
from mfcc_tpu.ops import chain as jchain
from mfcc_tpu_torch.config import NAMED_CONFIGS as T_CONFIGS
from mfcc_tpu_torch.ops import chain as tchain

CEILING = 5e-2  # both packages' max abs error from float64 on the valid frames


def test_spectrogram_fed_8k_centered_against_float64():
    over = dict(input_sample_rate=8000, frame_tail="center")
    tcfg, jcfg = T_CONFIGS["kaldi_spectrogram"].replace(**over), J_CONFIGS["kaldi_spectrogram"].replace(**over)
    x = np.round(np.random.default_rng(8000).standard_normal((1, 4000)) * 3000).astype(np.float32)
    lens = np.array([4000], np.int32)
    feat, mask = tchain.extract_batch(x, lens, tcfg, device="cpu")
    f64, mask64 = tchain.extract_batch(x, lens, tcfg.replace(dtype="float64"), device="cpu")
    jfeat, jmask = jchain.extract_batch(jnp.asarray(x), jnp.asarray(lens), jcfg, backend="jnp")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(mask.numpy(), mask64.numpy())
    valid = mask.numpy().astype(bool)
    f64 = f64.double().numpy()
    err = float(np.abs(feat.double().numpy() - f64)[valid].max())
    jerr = float(np.abs(np.asarray(jfeat, np.float64) - f64)[valid].max())
    assert np.isfinite(err) and np.isfinite(jerr)
    assert err <= jerr < CEILING, (err, jerr)
