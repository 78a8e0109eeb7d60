"""Serving surface of the port (generation-first).

  api      GenerateSpec and CacheOverflowError
  kvpages  the KVPagePool page allocator (refcounts, backpressure,
           copy-on-write, prefix index)
  decode   the continuous-batching DecodeScheduler (slotted and paged),
           sampling, request validation and the serial
           ``reference_generate`` it is held against
"""
from repro_torch.serving.api import CacheOverflowError, GenerateSpec  # noqa: F401
from repro_torch.serving.decode import (DecodeScheduler,  # noqa: F401
                                        GenResult, paged_page_count,
                                        reference_generate, sample_first,
                                        sample_tokens, validate_spec,
                                        validate_spec_paged)
from repro_torch.serving.kvpages import (KVPagePool,  # noqa: F401
                                         KVPageStats, page_hashes)
