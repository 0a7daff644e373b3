"""The port's command-line interface: `python -m mfcc_tpu_torch.cli`."""

from mfcc_tpu_torch.cli.main import main  # noqa: F401
