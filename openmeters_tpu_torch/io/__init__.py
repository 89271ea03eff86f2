"""File IO: WAV fixtures in (port of ``io/``)."""

from openmeters_tpu_torch.io.wav import read_wav, write_wav  # noqa: F401
