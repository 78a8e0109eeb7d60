"""Serving surface of the port (generation-first).

  api      GenerateSpec and CacheOverflowError
  decode   sampling, request validation and the serial
           ``reference_generate`` (the slotted ``DecodeScheduler`` is
           ROADMAP queue 1 item 5, next slice)
"""
from repro_torch.serving.api import CacheOverflowError, GenerateSpec  # noqa: F401
from repro_torch.serving.decode import (reference_generate,  # noqa: F401
                                        sample_first, sample_tokens,
                                        validate_spec)
