"""Serving surface of the port (generation-first).

  api      Request / GenerateSpec / RequestClass / Response / stats +
           typed errors (AdmissionError, UnknownModelError,
           CacheOverflowError)
  kvpages  the KVPagePool page allocator (refcounts, backpressure,
           copy-on-write, prefix index)
  decode   the continuous-batching DecodeScheduler (slotted and paged),
           sampling, request validation and the serial
           ``reference_generate`` it is held against
  policy   keep-alive eviction policies (TTL, never-evict)
  pool     FunctionInstance (owns a DecodeScheduler when live) +
           per-model InstancePool (exclusive + shared-generation holds)
  router   thread-safe Router: admission control, priority dispatch,
           generation requests join running decode batches
  autoscale
           the SLO Autoscaler: arrival-rate slope + queue depth ->
           prewarms off the request path, scale-in on idle
  engine   ServerlessPlatform (trace replay on the Router, one-shot or
           generation) + the BatchedLMServer shim
  trace    bursty Azure-like invocation workload generator

The node-local WeightCache (repro_torch.store.cache) is re-exported here:
one cache per platform makes scale-out cold starts reuse retrieved
weights and single-flight store reads.
"""
from repro_torch.serving.api import (AdmissionError,  # noqa: F401
                                     CacheOverflowError, GenerateSpec,
                                     PoolStats, Request, RequestClass,
                                     Response, RouterStats,
                                     UnknownModelError)
from repro_torch.serving.decode import (DecodeScheduler,  # noqa: F401
                                        GenResult, paged_page_count,
                                        reference_generate, sample_first,
                                        sample_tokens, validate_spec,
                                        validate_spec_paged)
from repro_torch.serving.kvpages import (KVPagePool,  # noqa: F401
                                         KVPageStats, page_hashes)
from repro_torch.serving.policy import (EvictionPolicy,  # noqa: F401
                                        KeepAliveTTL, NeverEvict,
                                        make_policy)
from repro_torch.serving.pool import FunctionInstance, InstancePool  # noqa: F401
from repro_torch.serving.router import Router  # noqa: F401
from repro_torch.serving.autoscale import Autoscaler  # noqa: F401
from repro_torch.serving.engine import (BatchedLMServer,  # noqa: F401
                                        ServerlessPlatform)
from repro_torch.store.cache import CacheStats, WeightCache  # noqa: F401
