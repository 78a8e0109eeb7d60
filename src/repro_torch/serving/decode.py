"""Continuous-batching decode: the slotted and paged ``DecodeScheduler``,
sampling, request validation and the serial generation reference.

One :class:`DecodeScheduler` holds a fixed-capacity decode state — a
slotted KV cache ``init_cache(n_slots, cache_len)``, or, with
``kv_page_tokens=``, shared page pools managed by a
:class:`~repro_torch.serving.kvpages.KVPagePool` with prefix reuse — and
decodes every resident request with one batched step of ``B = n_slots``
rows, whatever the occupancy:

  * a request **joins** at a step boundary: its prompt is prefilled into
    a fresh ``B=1`` cache on the calling thread, then copied into a free
    slot (or packed into pool pages) by the stepping thread between two
    steps;
  * a request **leaves** on completion or EOS, freeing its slot (and
    releasing its pages) for the next joiner;
  * the step is **cooperatively driven**: any caller thread blocked in
    :meth:`DecodeScheduler.generate` may run the next one.

The port writes caches and pools in place (the reference builds new
arrays), so everything that writes them — the step, joins, page packs
and copy-on-write copies — runs on the stepping thread only, between
steps.  A request's prefill writes only its own ``B=1`` cache, and reads
only prefix pages it has pinned (which no step writes).

Correctness invariant: each request's tokens equal
:func:`reference_generate`'s serial ``B=1`` loop, because every per-row
computation (its own cache rows or pages, the row-independent
``quant_matmul`` and attention kernels, sampling keyed by seed and
position) is independent of the other rows.

Sampling rule (shared by the first token and every decode step):
temperature 0 is greedy ``argmax``; temperature > 0 draws from the
softmax of ``logits / temperature`` with a ``torch.Generator`` seeded from
``(seed, position)``, so each row is deterministic and independent of the
other rows.  The port does not reproduce JAX's random bits.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import analysis, metrics as metrics_mod
from repro_torch import tree as tree_util
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.serving import kvpages
from repro_torch.serving.api import CacheOverflowError, GenerateSpec

PyTree = Any


def _row_seed(seed: int, pos: int) -> int:
    return (int(seed) * 1_000_003 + int(pos)) % (1 << 63)


def sample_tokens(logits: torch.Tensor, seed: torch.Tensor,
                  next_pos: torch.Tensor,
                  temperature: torch.Tensor) -> torch.Tensor:
    """Per-row next-token choice.  logits: (B, V); seed / next_pos /
    temperature: (B,).  Returns (B,) int32."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = temperature.tolist()
    if not any(t > 0 for t in temps):
        return out
    seeds, poss = seed.tolist(), next_pos.tolist()
    for b, t in enumerate(temps):
        if t <= 0:
            continue
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(_row_seed(seeds[b], poss[b]))
        probs = torch.softmax(logits[b].float() / max(t, 1e-6), dim=-1)
        out[b] = torch.multinomial(probs, 1, generator=gen)[0].to(
            torch.int32)
    return out


def sample_first(logits: torch.Tensor, spec: GenerateSpec,
                 n_prompt: int) -> int:
    """First token from full-prompt logits ((1, S, V): prefill output or
    the cold pipeline's in-flight forward)."""
    dev = logits.device
    return int(sample_tokens(
        logits[:, -1, :],
        torch.tensor([spec.seed], device=dev),
        torch.tensor([n_prompt], device=dev),
        torch.tensor([spec.temperature], dtype=torch.float32,
                     device=dev))[0])


def validate_spec(spec: GenerateSpec, n_prompt: int, cache_len: int) -> int:
    """Clamp n_new to the per-request max_len and validate against the
    KV cache capacity; returns the effective n_new."""
    n_new = int(spec.n_new)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {spec.n_new}")
    if spec.max_len is not None:
        n_new = min(n_new, int(spec.max_len) - n_prompt)
        if n_new < 1:
            raise CacheOverflowError(
                f"max_len={spec.max_len} leaves no room to generate "
                f"after a {n_prompt}-token prompt")
    if n_prompt + n_new > cache_len:
        raise CacheOverflowError(
            f"prompt ({n_prompt}) + n_new ({n_new}) = {n_prompt + n_new} "
            f"tokens overflow the decode cache (cache_len={cache_len}); "
            f"lower n_new / set max_len <= {cache_len} or provision a "
            f"larger cache")
    return n_new


def validate_spec_paged(spec: GenerateSpec, n_prompt: int, *,
                        page_tokens: int, n_pages: int,
                        stats: Optional[kvpages.KVPageStats] = None) -> int:
    """Paged admission check: the only *error* is a request that could
    never fit the page budget (anything smaller is blocking backpressure
    in the pool).  Returns the effective n_new.  ``n_pages`` is the
    per-request page ceiling — min(pool budget, page-table width)."""
    n_new = int(spec.n_new)
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {spec.n_new}")
    if spec.max_len is not None:
        n_new = min(n_new, int(spec.max_len) - n_prompt)
        if n_new < 1:
            raise CacheOverflowError(
                f"max_len={spec.max_len} leaves no room to generate "
                f"after a {n_prompt}-token prompt")
    need = -(-(n_prompt + n_new) // page_tokens)
    if need > n_pages:
        occ = ""
        if stats is not None:
            occ = (f"; live occupancy {stats.used}/{stats.total} pages "
                   f"({stats.pinned} pinned, {stats.cached} cached)")
        raise CacheOverflowError(
            f"prompt ({n_prompt}) + n_new ({n_new}) needs {need} KV pages "
            f"but the per-request budget is {n_pages} pages x "
            f"{page_tokens} tokens = {n_pages * page_tokens} tokens{occ}; "
            f"lower n_new / set max_len or raise the page budget "
            f"(kv_budget_bytes)")
    return n_new


def paged_page_count(model, *, page_tokens: int,
                     budget_bytes: Optional[int] = None,
                     n_slots: int = 8, cache_len: int = 256) -> int:
    """Page budget for a scheduler: ``budget_bytes`` over the per-page
    device footprint across all paged layers, else (no byte budget, or no
    paged layers) the slotted arena's worth of pages."""
    per_page = model.kv_page_bytes(page_tokens)
    if budget_bytes and per_page > 0:
        n = int(budget_bytes) // per_page
        if n < 1:
            raise ValueError(
                f"kv budget {budget_bytes} B below one page "
                f"({per_page} B across paged layers)")
        return n
    return n_slots * (-(-cache_len // page_tokens))


def _as_prompt(prompt, device: torch.device) -> torch.Tensor:
    arr = torch.as_tensor(prompt).to(device=device, dtype=torch.int64)
    if arr.dim() == 1:
        arr = arr[None, :]
    if arr.dim() != 2 or arr.shape[0] != 1 or arr.shape[1] < 1:
        raise ValueError(f"prompt must be (S,) or (1, S), got "
                         f"{tuple(arr.shape)}")
    return arr


def _check_placement(model, params: PyTree, dev: torch.device, what: str):
    if model.device != dev:
        raise ValueError(f"model is built for {model.device}, {what} on "
                         f"{dev}")
    for leaf in tree_util.leaves(params):
        if leaf.device != dev:
            raise ValueError(f"params live on {leaf.device}, {what} on "
                             f"{dev}")


# ---------------------------------------------------------------------------
# results + per-request bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GenResult:
    """What one generation request produced."""
    tokens: List[int]            # emitted ids, first token included
    token_times: List[float]     # monotonic emission time per token
    n_prompt: int

    @property
    def t_first(self) -> float:
        return self.token_times[0]

    @property
    def tpot_s(self) -> List[float]:
        """Inter-token intervals (len == len(tokens) - 1)."""
        tt = self.token_times
        return [tt[i] - tt[i - 1] for i in range(1, len(tt))]


class _Active:
    """One resident request (pending join or holding a slot)."""

    def __init__(self, spec: GenerateSpec, cache1: PyTree, first: int,
                 t_first: float, n_prompt: int, n_new: int):
        self.spec = spec
        self.cache1 = cache1            # B=1 prefilled cache, until joined
        self.tokens = [first]
        self.times = [t_first]
        self.n_prompt = n_prompt
        self.remaining = n_new - 1
        self.done = False
        self.error: Optional[BaseException] = None
        # paged mode only: reserved physical pages (prefix hits first),
        # how many of them were prefix hits, and the prompt's running
        # page hashes (published after the pack)
        self.page_ids: List[int] = []
        self.n_hit = 0
        self.hashes: List[str] = []

    @property
    def next_pos(self) -> int:
        """Absolute position of the next input token (the last emitted
        one): the prompt occupies [0, S), generated token i sits at S+i."""
        return self.n_prompt + len(self.tokens) - 1


def _subtree(tree: PyTree, path: Tuple[str, ...]) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _join_slot(cache: PyTree, one: PyTree, slot: int):
    """Copy a B=1 cache into batch row ``slot`` of the batched cache, in
    place.  The top-level key tells the layout: stacked pattern groups
    (``s*``) have leaves ``(n_units, B, ...)``, tail layers (``t*``)
    ``(B, ...)``.  ``None`` leaves (paged K/V) are skipped."""
    for path, big in tree_util.leaves_with_path(cache):
        if big is None:
            continue
        small = _subtree(one, path)
        if path[0].startswith("s"):
            big[:, slot].copy_(small[:, 0])
        else:
            big[slot].copy_(small[0])


class DecodeScheduler:
    """Continuous-batching decode over one slotted KV cache, or over page
    pools with ``kv_page_tokens=`` (prefix reuse included).

    Thread-safe: any number of threads may call :meth:`generate`
    concurrently; their requests share the batched step.  ``n_slots``
    bounds concurrent residency — an (n_slots+1)-th caller blocks until a
    slot frees.  The scheduler runs on the model's device: on the GPU
    its prefill and step go through the CUDA kernels
    (:meth:`kernel_modes`).

    Paged mode: ``kv_page_tokens`` positions per page; the page budget
    is ``kv_budget_bytes`` over the per-page footprint (default: the
    slotted arena's worth); ``kv_max_seq`` bounds one request's logical
    extent (the page-table width, default ``cache_len``).
    """

    def __init__(self, model, params: PyTree, *, n_slots: int = 8,
                 cache_len: int = 256,
                 kv_page_tokens: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None,
                 kv_max_seq: Optional[int] = None,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if cache_len < 2:
            raise ValueError(f"cache_len must be >= 2, got {cache_len}")
        self.model = model
        self.params = params
        self.device = model.device
        _check_placement(model, params, self.device, "scheduling")
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.paged = kv_page_tokens is not None
        m = metrics_mod.resolve(metrics)
        if self.paged:
            pt = int(kv_page_tokens)
            if pt < 1:
                raise ValueError(
                    f"kv_page_tokens must be >= 1, got {kv_page_tokens}")
            self.page_tokens = pt
            self.n_pages = paged_page_count(
                model, page_tokens=pt, budget_bytes=kv_budget_bytes,
                n_slots=self.n_slots, cache_len=self.cache_len)
            self.np_max = max(1, min(
                self.n_pages,
                -(-int(kv_max_seq if kv_max_seq is not None
                       else self.cache_len) // pt)))
            self.kvpool = kvpages.KVPagePool(
                n_pages=self.n_pages, page_tokens=pt,
                page_bytes=model.kv_page_bytes(pt),
                model_key=model.cfg.name, metrics=m)
            # the pools carry one trailing scratch page that inactive
            # batch rows write into
            self._kvpages = model.init_kv_pages(self.n_pages + 1, pt)
            self._cache = model.init_cache_paged(self.n_slots,
                                                 self.cache_len)
            self._tables = np.full((self.n_slots, self.np_max),  # guarded-by: _cv
                                   self.kvpool.scratch_id, np.int32)
            # prefix reuse needs every sequence state paged; a model with
            # any slot-resident kind (ring, SSM or RG-LRU state) pages its
            # full-attention K/V but keeps the slotted length ceiling
            self._prefix_ok = model.supports_prefix_cache
            self._all_paged = set(model.paged_kinds()) == set(
                model.pattern) | set(model.tail_kinds)
        else:
            self._cache = model.init_cache(self.n_slots, self.cache_len)
        # host-side per-slot step inputs
        self._tok = np.zeros((self.n_slots, 1), np.int64)    # guarded-by: _cv
        self._pos = np.zeros((self.n_slots,), np.int32)      # guarded-by: _cv
        self._seed = np.zeros((self.n_slots,), np.int64)     # guarded-by: _cv
        self._temp = np.zeros((self.n_slots,), np.float32)   # guarded-by: _cv
        self._cv = analysis.make_condition("DecodeScheduler._cv")
        self._free: List[int] = list(range(self.n_slots))  # guarded-by: _cv
        self._slots: Dict[int, _Active] = {}               # guarded-by: _cv
        self._pending: deque = deque()                     # guarded-by: _cv
        self._stepping = False                             # guarded-by: _cv
        self.steps = 0
        self.max_occupancy = 0
        self.joined = 0
        self._m_steps = m.counter("decode/steps")
        self._m_joined = m.counter("decode/joined")
        self._m_occ = m.gauge("decode/occupancy")

    # ------------------------------------------------------------ public API
    def generate(self, spec: GenerateSpec, *,
                 first_token: Optional[int] = None,
                 t_first: Optional[float] = None) -> GenResult:
        """Serve one generation request; blocks until it completes.

        ``first_token``/``t_first`` inject a token already produced
        elsewhere — the cold-start path, where the loading pipeline's own
        forward answers the prompt: the prompt is still prefilled here to
        build the request's cache, but its logits are discarded and
        generation resumes at position S+1.
        """
        prompt = _as_prompt(spec.prompt, self.device)
        n_prompt = int(prompt.shape[1])
        if self.paged:
            return self._generate_paged(spec, prompt, n_prompt,
                                        first_token, t_first)
        n_new = validate_spec(spec, n_prompt, self.cache_len)
        cache1 = self.model.init_cache(1, self.cache_len)
        logits, cache1 = self.model.prefill(self.params, {"tokens": prompt},
                                            cache1)
        if first_token is None:
            first_token = sample_first(logits, spec, n_prompt)
            t_first = time.monotonic()
        req = _Active(spec, cache1, int(first_token), float(t_first),
                      n_prompt, n_new)
        return self._run(req)

    def _generate_paged(self, spec: GenerateSpec, prompt: torch.Tensor,
                        n_prompt: int, first_token, t_first) -> GenResult:
        """Paged admission: reserve whole pages (prefix hits first, the
        rest all-or-nothing from the pool — blocking backpressure), prefill
        only the unshared suffix, then join like a slotted request."""
        pt = self.page_tokens
        n_new = validate_spec_paged(spec, n_prompt, page_tokens=pt,
                                    n_pages=self.np_max,
                                    stats=self.kvpool.stats())
        if not self._all_paged:
            # slot-resident state (rings, SSM and RG-LRU states) keeps
            # its ceiling
            n_new = validate_spec(spec, n_prompt, self.cache_len)
        need = -(-(n_prompt + n_new) // pt)
        hit: List[int] = []
        hashes_full: List[str] = []
        if self._prefix_ok:
            hashes_full = kvpages.page_hashes(self.kvpool.model_key,
                                              prompt[0].cpu().numpy(), pt)
            # a hit must leave a non-empty prefill suffix (the request's
            # own logits come from its last prompt token)
            hit = self.kvpool.match_prefix(
                hashes_full[:min(len(hashes_full), (n_prompt - 1) // pt)])
        try:
            new = self.kvpool.alloc(need - len(hit), timeout=120.0)
        except TimeoutError:
            # our own prefix pins may be what starves the pool: drop them
            # and queue for the whole span like a cold request
            self.kvpool.release(hit)
            hit = []
            new = self.kvpool.alloc(need)
        page_ids = list(hit) + list(new)
        try:
            cache1 = self.model.init_request_cache(need * pt, self.cache_len)
            off = len(hit) * pt
            if off:
                # hit pages are pinned, so no step writes them
                self.model.gather_pages(cache1, self._kvpages, torch.tensor(
                    hit, dtype=torch.int32, device=self.device))
                logits, cache1 = self.model.prefill_continue(
                    self.params, {"tokens": prompt[:, off:]}, cache1,
                    off=off)
            else:
                logits, cache1 = self.model.prefill(
                    self.params, {"tokens": prompt}, cache1)
            if first_token is None:
                first_token = sample_first(logits, spec, n_prompt)
                t_first = time.monotonic()
            req = _Active(spec, cache1, int(first_token), float(t_first),
                          n_prompt, n_new)
            req.page_ids = page_ids
            req.n_hit = len(hit)
            req.hashes = hashes_full
        except BaseException:
            self.kvpool.release(page_ids)
            raise
        return self._run(req)

    def _run(self, req: _Active) -> GenResult:
        spec = req.spec
        if req.remaining == 0 or (spec.eos_id is not None
                                  and req.tokens[-1] == spec.eos_id):
            if req.page_ids:
                self.kvpool.release(req.page_ids)
            return GenResult(req.tokens, req.times, req.n_prompt)
        with self._cv:
            self._pending.append(req)
            self._cv.notify_all()
        self._pump(req)
        if req.error is not None:
            raise req.error
        return GenResult(req.tokens, req.times, req.n_prompt)

    def kernel_modes(self) -> Dict[str, str]:
        """Per kernel, what this scheduler's device runs: ``"cuda"`` (the
        hand-written kernel) on the GPU, ``"plain"`` (its PyTorch
        version) on the CPU."""
        mode = "cuda" if self.device.type == "cuda" else "plain"
        return {name: mode for name in ops.registry.names()}

    def stats(self) -> Dict[str, int]:
        with self._cv:
            out = {"steps": self.steps, "joined": self.joined,
                   "max_occupancy": self.max_occupancy,
                   "active": len(self._slots) + len(self._pending),
                   "n_slots": self.n_slots}
        if self.paged:
            ps = self.kvpool.stats()
            out.update(kv_page_tokens=self.page_tokens,
                       kv_pages_total=ps.total, kv_pages_used=ps.used,
                       kv_pages_pinned=ps.pinned,
                       kv_prefix_hits=ps.prefix_hits,
                       kv_prefix_misses=ps.prefix_misses)
        return out

    def reset_peaks(self):
        """Re-arm the max_occupancy watermark at the current occupancy."""
        with self._cv:
            self.max_occupancy = len(self._slots)

    # -------------------------------------------------------- cooperative drive
    def _admit_locked(self):
        """Move pending joins into free slots (caller holds the lock and
        is the stepping thread) — the step boundary where requests enter
        the batch and their caches are copied in."""
        while self._pending and self._free:
            req = self._pending.popleft()
            slot = min(self._free)
            self._free.remove(slot)
            if self.paged:
                self._join_paged_locked(req, slot)
            else:
                _join_slot(self._cache, req.cache1, slot)
            req.cache1 = None
            self._slots[slot] = req
            self._tok[slot, 0] = req.tokens[-1]
            self._pos[slot] = req.next_pos
            self._seed[slot] = int(req.spec.seed)
            self._temp[slot] = float(req.spec.temperature)
            self.joined += 1
            self.max_occupancy = max(self.max_occupancy, len(self._slots))
            self._m_joined.inc()
            self._m_occ.set(len(self._slots))

    def _join_paged_locked(self, req: _Active, slot: int):
        """Paged half of admission: merge the slot-resident state, move
        the new prompt pages from the request's prefill cache into the
        pools, publish their hashes, point the slot's table row at them."""
        _join_slot(self._cache, self.model.strip_paged(req.cache1), slot)
        n_pp = -(-req.n_prompt // self.page_tokens)   # pages holding prompt
        ids = req.page_ids
        # copy-on-write guard on the pack targets: fresh allocations have
        # refcount 1, so this forks only if sharing ever reaches them
        for j in range(req.n_hit, n_pp):
            pid, copied = self.kvpool.ensure_writable(ids[j])
            if copied:
                self.model.copy_page(self._kvpages, ids[j], pid)
                ids[j] = pid
        if n_pp > req.n_hit:
            self.model.pack_pages(
                self._kvpages, req.cache1,
                torch.tensor(ids[req.n_hit:n_pp], dtype=torch.int32,
                             device=self.device), req.n_hit)
        # publish full prompt pages only; a partial last page keeps
        # receiving decode writes
        for j in range(req.n_hit, min(len(req.hashes), n_pp)):
            self.kvpool.register(ids[j], req.hashes[j])
        self._tables[slot, :] = self.kvpool.scratch_id
        self._tables[slot, :len(ids)] = ids

    def _leave_paged_locked(self, req: _Active, slot: int):
        """Release a leaver's pages and park its table row on scratch."""
        self._tables[slot, :] = self.kvpool.scratch_id
        self.kvpool.release(req.page_ids)
        req.page_ids = []

    def _fail_locked(self, e: BaseException):
        """Abort every resident request with ``e``: a failed step or join
        leaves no thread parked forever."""
        self._stepping = False
        for req in list(self._slots.values()) + list(self._pending):
            req.error = e
            if self.paged and req.page_ids:
                self.kvpool.release(req.page_ids)
                req.page_ids = []
        if self.paged:
            self._tables[:, :] = self.kvpool.scratch_id
        self._slots.clear()
        self._pending.clear()
        self._free = list(range(self.n_slots))
        self._cv.notify_all()

    @torch.no_grad()
    def _pump(self, my: _Active):
        """Drive batched steps until ``my`` completes.  Exactly one thread
        steps at a time; the others wait on the CV.  Every resident
        request has a caller thread parked here, so a stepper exists
        while work remains."""
        dev = self.device
        while True:
            with self._cv:
                while True:
                    if my.done or my.error is not None:
                        return
                    if not self._stepping:
                        break
                    self._cv.wait()
                self._stepping = True
                try:
                    self._admit_locked()
                    tok = torch.tensor(self._tok, device=dev)
                    pos = torch.tensor(self._pos, device=dev)
                    seed = torch.tensor(self._seed, device=dev)
                    temp = torch.tensor(self._temp, device=dev)
                    if self.paged:
                        tables = torch.tensor(self._tables, device=dev)
                except BaseException as e:
                    self._fail_locked(e)
                    raise
            try:
                # only this (stepping) thread writes the caches and pools
                if self.paged:
                    logits, _, _ = self.model.decode_step_paged(
                        self.params, self._cache, self._kvpages, tables,
                        tok, pos)
                else:
                    logits, _ = self.model.decode_step(self.params,
                                                       self._cache, tok, pos)
                nxt = sample_tokens(logits[:, -1, :], seed, pos + 1,
                                    temp).tolist()
            except BaseException as e:
                with self._cv:
                    self._fail_locked(e)
                raise
            t_now = time.monotonic()
            with self._cv:
                self.steps += 1
                for slot in list(self._slots):
                    req = self._slots[slot]
                    t = int(nxt[slot])
                    req.tokens.append(t)
                    req.times.append(t_now)
                    req.remaining -= 1
                    self._tok[slot, 0] = t
                    self._pos[slot] += 1
                    if req.remaining == 0 or \
                            (req.spec.eos_id is not None
                             and t == req.spec.eos_id):
                        req.done = True
                        del self._slots[slot]
                        self._free.append(slot)
                        if self.paged:
                            self._leave_paged_locked(req, slot)
                self._m_steps.inc()
                self._m_occ.set(len(self._slots))
                self._stepping = False
                self._cv.notify_all()


# ---------------------------------------------------------------------------
# serial reference — the oracle the batched scheduler must match
# ---------------------------------------------------------------------------

@torch.no_grad()
def reference_generate(model, params: PyTree, prompt, *, n_new: int,
                       cache_len: int = 256, temperature: float = 0.0,
                       seed: int = 0, eos_id: Optional[int] = None,
                       max_len: Optional[int] = None,
                       device: DeviceLike = None) -> List[int]:
    """Serial B=1 ``prefill`` + ``decode_step`` loop with the sampling
    rule above — token-level ground truth for the generation tests.

    device: where to generate (default: the GPU; raises without one unless
    ``device="cpu"``); ``model`` and ``params`` must live there."""
    dev = resolve_device(device)
    _check_placement(model, params, dev, "generating")
    spec = GenerateSpec(prompt=prompt, n_new=n_new, temperature=temperature,
                        max_len=max_len, eos_id=eos_id, seed=seed)
    prompt = _as_prompt(prompt, dev)
    S = int(prompt.shape[1])
    n_new = validate_spec(spec, S, cache_len)

    cache = model.init_cache(1, cache_len)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    out = [sample_first(logits, spec, S)]
    seeds = torch.tensor([seed], device=dev)
    temps = torch.tensor([temperature], dtype=torch.float32, device=dev)
    cur = torch.tensor([[out[0]]], dtype=torch.int64, device=dev)
    for t in range(S, S + n_new - 1):
        if eos_id is not None and out[-1] == eos_id:
            break
        pos = torch.tensor([t], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, cache, cur, pos)
        nxt = sample_tokens(logits[:, -1, :], seeds, pos + 1, temps)
        cur = nxt[:, None].to(torch.int64)
        out.append(int(nxt[0]))
    return out
