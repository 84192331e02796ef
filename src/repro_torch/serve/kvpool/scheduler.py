"""Continuous batching over the paged, prefix-shared FZ KV pool: the port of
``repro/serve/kvpool/scheduler.py``, with the same deterministic tie-breaks.

vLLM-style serving loop at the scale of this repo: requests arrive over time
(``Request.arrive_at``, in scheduler steps), are admitted into a fixed number
of decode *lanes* (the decode batch width, so the decode step compiles once),
every step decodes one token for every running sequence, and memory pressure
is resolved by *compress-parking* — a preempted sequence's pages are
FZ-compressed in place and its lane freed; nothing is recomputed on resume.
State machine per request:

    WAITING --admit(prefill -> raw pages)--> RUNNING
    RUNNING --preempt(compress all pages)--> PARKED
    PARKED  --resume(promote tail page)----> RUNNING
    RUNNING --n_new tokens emitted---------> FINISHED

Admission first walks the pool's radix prefix index: a hit maps the matched
prefix onto existing (possibly shared, possibly compressed) pages and only
the *suffix* is prefilled — ``engine.prefill_suffix`` computes K/V for the
unmatched tokens attending to the cached prefix, and the prompt's pages are
then cached in the tree for the next arrival. A miss (or ``prefix_mode
"off"``, or an engine without suffix prefill) takes the full-prefill path,
byte-for-byte the non-shared scheduler.

Scheduling order is fully deterministic, including under equal priority and
equal arrival: admission sorts by (priority desc, arrive_at asc, req_id asc),
resume by (priority desc, arrival asc, req_id asc), and preemption picks the
lowest priority / latest arrival / highest seq id victim — so trace-driven
benchmarks reproduce run-to-run.

Every step also runs the routine cooling pass: pages unwritten for
``cold_after`` steps tier down to compressed, which is what creates capacity
for more concurrent sequences than the raw slab could hold. Latency is
tracked in scheduler steps: TTFT (admission step minus arrival) and
inter-token gaps (preemption stretches them) land in ``TraceStats`` per
request for the SLO accounting in ``tracegen.latency_summary``.
Deliberate differences from the reference: the counters are fields of
the batcher (``TraceStats``, same names) until the ``obs`` slice, and the
per-step health gate (``sentinels.note_scheduler`` / ``assert_healthy``)
waits for that slice too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .policy import TieredPolicy
from .pool import PagePool
from .radix import EMPTY_MATCH, PrefixMatch

WAITING, RUNNING, PARKED, FINISHED = "waiting", "running", "parked", "finished"


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    tokens: np.ndarray          # (S,) int32 prompt
    n_new: int                  # tokens to generate (incl. the prefill argmax)
    priority: int = 0           # higher wins admission / survives preemption
    arrive_at: int = 0          # scheduler step the request becomes admissible


@dataclasses.dataclass
class SeqRecord:
    req: Request
    state: str = WAITING
    lane: int | None = None
    arrival: int = 0            # admission step (preemption recency key)
    generated: list[int] = dataclasses.field(default_factory=list)
    last_token: int = 0
    ttft: int | None = None     # steps from arrive_at to the first token
    last_emit: int = 0          # step of the most recent token (ITL clock)
    itl: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TraceStats:
    """Snapshot of one batcher's serving counters: its own counts, the pool's
    counters, and per-request latency in scheduler steps."""
    decode_steps: int = 0
    admissions: int = 0
    preemptions: int = 0
    resumes: int = 0
    completed: int = 0
    tiered_pages: int = 0
    high_water_used_bytes: int = 0     # raw slab in use + compressed payloads
    high_water_demand_bytes: int = 0   # same live pages if held fully raw
    high_water_logical_bytes: int = 0  # per-seq mappings if raw and private
    pool_compressions: int = 0
    pool_decompressions: int = 0
    # prefix sharing
    prefix_hits: int = 0               # admissions that matched a cached prefix
    prefill_tokens: int = 0            # tokens actually pushed through prefill
    prefill_tokens_saved: int = 0      # prompt tokens served from the radix cache
    cow_promotions: int = 0            # shared-page writes forked to a copy
    shared_cold_reads_deduped: int = 0  # per-step cold decodes avoided by dedup
    decompress_dispatches: int = 0     # vmapped cold-read dispatches issued
    # latency (scheduler steps), per req_id — joined with SLOs in tracegen
    ttft_steps: dict[int, int] = dataclasses.field(default_factory=dict)
    itl_steps: dict[int, list[int]] = dataclasses.field(default_factory=dict)


# TraceStats fields the batcher counts itself
_SCHED_FIELDS = ("decode_steps", "admissions", "preemptions", "resumes", "completed",
                 "tiered_pages", "prefix_hits", "prefill_tokens", "prefill_tokens_saved")


class ContinuousBatcher:
    """admit / step / preempt / resume over a (possibly timed) request trace."""

    def __init__(self, engine, pool: PagePool, *, max_batch: int = 2,
                 policy: TieredPolicy | None = None, max_steps: int = 10_000):
        self.engine = engine
        self.pool = pool
        self.max_batch = max_batch
        self.policy = policy or TieredPolicy(cold_after=pool.cfg.cold_after)
        self.max_steps = max_steps
        self.paged_decode = bool(getattr(engine, "paged_decode_enabled", False))
        # prefix sharing needs both the pool's radix index and an engine that
        # can prefill a suffix against cached prefix K/V; without either, the
        # loop is byte-for-byte the non-shared scheduler
        self.prefix = (pool.radix is not None
                       and callable(getattr(engine, "prefill_suffix", None)))
        self.lanes: list[int | None] = [None] * max_batch
        self.recs: dict[int, SeqRecord] = {}
        self._counts = dict.fromkeys(_SCHED_FIELDS, 0)
        self._ttft_steps: dict[int, int] = {}
        self._itl_steps: dict[int, list[int]] = {}

    # -- counters -------------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        self._counts[name] += n

    @property
    def stats(self) -> TraceStats:
        """Snapshot: the batcher's counts + the pool's own counters."""
        ps = self.pool.stats
        return TraceStats(
            **self._counts,
            high_water_used_bytes=ps.high_water_bytes,
            high_water_demand_bytes=ps.high_water_demand_bytes,
            high_water_logical_bytes=ps.high_water_logical_bytes,
            pool_compressions=ps.compressions,
            pool_decompressions=ps.decompressions,
            cow_promotions=ps.cow_promotions,
            shared_cold_reads_deduped=ps.shared_cold_reads_deduped,
            decompress_dispatches=ps.decompress_dispatches,
            ttft_steps=dict(self._ttft_steps),
            itl_steps={k: list(v) for k, v in self._itl_steps.items()})

    # -- bookkeeping ----------------------------------------------------------

    def _running(self) -> dict[int, tuple[int, int]]:
        return {seq: (rec.req.priority, rec.arrival)
                for seq, rec in self.recs.items() if rec.state == RUNNING}

    def _protect(self) -> set[int]:
        return self.policy.tail_pages(self.pool, self.lanes)

    def _tensor(self, values) -> torch.Tensor:
        """Token IDs / lengths as int32 on the pool's device."""
        return torch.as_tensor(np.asarray(values, np.int32), device=self.pool.device)

    def _free_lane(self) -> int | None:
        for i, seq in enumerate(self.lanes):
            if seq is None:
                return i
        return None

    def _park(self, seq: int, step: int) -> None:
        rec = self.recs[seq]
        self.policy.park(self.pool, seq)
        self.lanes[rec.lane] = None
        rec.lane, rec.state = None, PARKED
        self._count("preemptions")

    def _emit(self, rec: SeqRecord, tok: int, step: int) -> None:
        """Record one generated token + its latency sample."""
        if not rec.generated:
            rec.ttft = step - rec.req.arrive_at
        else:
            rec.itl.append(step - rec.last_emit)
        rec.generated.append(tok)
        rec.last_token, rec.last_emit = tok, step

    def _finish(self, seq: int, outputs: dict) -> None:
        rec = self.recs[seq]
        outputs[rec.req.req_id] = np.asarray(rec.generated[: rec.req.n_new],
                                             np.int32)
        self._ttft_steps[rec.req.req_id] = rec.ttft
        self._itl_steps[rec.req.req_id] = rec.itl[: rec.req.n_new - 1]
        self.pool.free_seq(seq)
        if rec.lane is not None:
            self.lanes[rec.lane] = None
        rec.lane, rec.state = None, FINISHED
        self._count("completed")

    def _preempt_for(self, step: int, *, admitting_priority: int | None = None) -> bool:
        """Park the policy victim to relieve pressure; returns True if parked.

        ``admitting_priority`` set: pressure comes from *admission*, and only
        running sequences with strictly lower priority are eligible victims.
        ``None``: pressure comes from a running sequence's tail write — every
        running sequence is eligible, including (as a last resort) the one
        that needs the slot.
        """
        running = self._running()
        if admitting_priority is not None:
            running = {s: pa for s, pa in running.items()
                       if pa[0] < admitting_priority}
        victim = self.policy.victim(running)
        if victim is None:
            return False
        self._park(victim, step)
        return True

    # -- admission / resume ---------------------------------------------------

    def _start_running(self, rec: SeqRecord, logits, step: int,
                       outputs: dict) -> None:
        """Common admission tail: lane assignment + first token + finish."""
        seq = rec.req.req_id
        lane = self._free_lane()
        self._emit(rec, int(torch.argmax(logits[0])), step)
        rec.lane, rec.state, rec.arrival = lane, RUNNING, step
        self.lanes[lane] = seq
        self._count("admissions")
        if len(rec.generated) >= rec.req.n_new:
            self._finish(seq, outputs)

    def _admit(self, rec: SeqRecord, step: int, outputs: dict) -> bool:
        prompt = np.asarray(rec.req.tokens, np.int32)
        match = self.pool.match_prefix(prompt) if self.prefix else EMPTY_MATCH
        if match.matched_tokens:
            return self._admit_suffix(rec, prompt, match, step, outputs)
        ps = self.pool.cfg.page_size
        n_pages = max(1, -(-len(prompt) // ps))
        while not self.policy.reclaim(self.pool, n_pages, self._protect()):
            if not self._preempt_for(step, admitting_priority=rec.req.priority):
                return False
        # pad the prompt to its page bucket so prefill compiles once per
        # bucket (max_pages_per_seq shapes), not once per prompt length;
        # "lengths" makes the model take logits at the true last position
        padded = np.zeros(n_pages * ps, np.int32)
        padded[: len(prompt)] = prompt
        logits, cache = self.engine.prefill(
            {"tokens": self._tensor(padded)[None],
             "lengths": self._tensor([len(prompt)])})
        seq = rec.req.req_id
        if not self.pool.write_prefill(seq, cache["k"], cache["v"],
                                       len(prompt), step):
            return False
        if self.prefix:
            self.pool.insert_prompt(seq, prompt, step)
        self._count("prefill_tokens", len(prompt))
        self._start_running(rec, logits, step, outputs)
        return True

    def _admit_suffix(self, rec: SeqRecord, prompt: np.ndarray,
                      match: PrefixMatch, step: int, outputs: dict) -> bool:
        """Prefix-hit admission: map the matched pages, prefill only the
        suffix against the cached prefix K/V, cache the new pages."""
        seq = rec.req.req_id
        ps = self.pool.cfg.page_size
        matched = match.matched_tokens
        demand = self.pool.admit_slot_demand(match, len(prompt))
        while not self.policy.reclaim(self.pool, demand, self._protect()):
            if not self._preempt_for(step, admitting_priority=rec.req.priority):
                return False
        if not self.pool.map_prefix(seq, match, step):
            return False
        # suffix padded to its page bucket: one prefill_suffix trace per
        # bucket shape, logits taken at the true last suffix position
        suffix = prompt[matched:]
        n_pages = max(1, -(-len(suffix) // ps))
        padded = np.zeros(n_pages * ps, np.int32)
        padded[: len(suffix)] = suffix
        prefix_view = self.pool.gather([seq])       # length == matched tokens
        logits, cache = self.engine.prefill_suffix(
            prefix_view,
            {"tokens": self._tensor(padded)[None],
             "lengths": self._tensor([len(suffix)])})
        if not self.pool.write_suffix(seq, cache["k"], cache["v"],
                                      len(suffix), step):
            self.pool.free_seq(seq)
            return False
        self.pool.insert_prompt(seq, prompt, step)
        self._count("prefix_hits")
        self._count("prefill_tokens", len(suffix))
        self._count("prefill_tokens_saved", matched)
        self._start_running(rec, logits, step, outputs)
        return True

    def _try_resume(self, rec: SeqRecord, step: int) -> bool:
        seq = rec.req.req_id
        if not self.policy.reclaim(self.pool, 1, self._protect()):
            return False
        lane = self._free_lane()
        rec.lane, rec.state = lane, RUNNING
        self.lanes[lane] = seq
        self._count("resumes")
        return True

    # -- the step -------------------------------------------------------------

    def _secure_tails(self, step: int) -> None:
        """Guarantee every running sequence can take this step's token write."""
        while True:
            # each pending append consumes at most one slot (fresh tail page,
            # CoW fork of a shared tail, or promotion of a compressed tail);
            # reserve them all at once
            reserve = sum(self.pool.tail_slot_demand(seq)
                          for seq in self.lanes if seq is not None)
            if reserve == 0 or self.policy.reclaim(self.pool, reserve,
                                                   self._protect()):
                return
            if not self._preempt_for(step):
                return                    # stall guard in run() handles this

    def step(self, step: int, outputs: dict) -> bool:
        """One scheduler iteration; returns True if any progress was made."""
        progress = False
        # 1. routine cooling
        self._count("tiered_pages",
                    self.policy.tier(self.pool, step, self._protect()))
        # 2. resume parked: highest priority, oldest, then req_id
        for rec in sorted((r for r in self.recs.values() if r.state == PARKED),
                          key=lambda r: (-r.req.priority, r.arrival,
                                         r.req.req_id)):
            if self._free_lane() is None:
                break
            progress |= self._try_resume(rec, step)
        # 3. admit arrived waiting: priority, arrival time, then req_id
        for rec in sorted((r for r in self.recs.values()
                           if r.state == WAITING and r.req.arrive_at <= step),
                          key=lambda r: (-r.req.priority, r.req.arrive_at,
                                         r.req.req_id)):
            if self._free_lane() is None:
                break
            progress |= self._admit(rec, step, outputs)
        # 4. secure tail capacity (may compress-park under pressure)
        self._secure_tails(step)
        # 5. decode one token for every running lane. Two wirings:
        #    * plain — gather the contiguous fixed-width cache, run the
        #      model's own decode (writes K/V into a copy), extract the token;
        #    * paged kernel (engine.paged_decode_enabled) — keep the page
        #      layout (gather_pages), run the decode step on K7, and append
        #      the returned fresh K/V; nothing is scattered into a
        #      seq_capacity-wide cache.
        active = [(i, seq) for i, seq in enumerate(self.lanes) if seq is not None]
        if active:
            tokens = self._tensor([self.recs[s].last_token if s is not None else 0
                                   for s in self.lanes])
            if self.paged_decode:
                pages = self.pool.gather_pages(self.lanes)
                logits, (k_new, v_new) = self.engine.decode_step_paged(pages,
                                                                       tokens)
            else:
                cache = self.pool.gather(self.lanes)
                logits, new_cache = self.engine.decode_step(cache, tokens)
            next_tokens = torch.argmax(logits, dim=-1).tolist()   # one host sync a step
            for lane, seq in active:
                rec = self.recs[seq]
                pos = self.pool.seq_len[seq]
                if self.paged_decode:
                    k_vec, v_vec = k_new[:, lane], v_new[:, lane]
                else:
                    k_vec, v_vec = new_cache["k"][:, lane, pos], new_cache["v"][:, lane, pos]
                if not self.pool.append_token(seq, k_vec, v_vec, step):
                    raise RuntimeError("kvpool invariant: tail write failed "
                                       "after _secure_tails")
                self._emit(rec, int(next_tokens[lane]), step)
                if len(rec.generated) >= rec.req.n_new:
                    self._finish(seq, outputs)
            self._count("decode_steps")
            progress = True
        return progress

    def run(self, requests: list[Request]) -> tuple[dict[int, np.ndarray],
                                                    TraceStats]:
        """Drive the full trace; returns ({req_id: tokens}, stats)."""
        ids = [r.req_id for r in requests]
        if len(set(ids)) != len(ids):
            raise ValueError("request ids must be unique")
        cfg = self.pool.cfg
        for r in requests:
            need = len(np.asarray(r.tokens)) + r.n_new - 1
            if need > cfg.seq_capacity:
                raise ValueError(
                    f"request {r.req_id}: prompt + n_new needs {need} token "
                    f"slots > seq_capacity {cfg.seq_capacity}")
            if -(-len(np.asarray(r.tokens)) // cfg.page_size) > cfg.num_pages:
                raise ValueError(
                    f"request {r.req_id}: prompt alone needs more pages than "
                    f"the {cfg.num_pages}-slot slab")
        self.recs = {r.req_id: SeqRecord(req=r) for r in requests}
        outputs: dict[int, np.ndarray] = {}
        stalled = 0
        step = 0
        while step < self.max_steps:
            step += 1
            if all(r.state == FINISHED for r in self.recs.values()):
                break
            if self.step(step, outputs):
                stalled = 0
                continue
            # idle, not stalled: nothing live yet but arrivals are coming —
            # fast-forward the clock to the next arrival
            future = [r.req.arrive_at for r in self.recs.values()
                      if r.state == WAITING and r.req.arrive_at > step]
            if future and not any(r.state in (RUNNING, PARKED)
                                  for r in self.recs.values()):
                step = min(future) - 1
                stalled = 0
                continue
            stalled += 1
            if stalled > 2:
                raise RuntimeError(
                    "kvpool scheduler stalled: pool too small for this trace "
                    f"({self.pool.cfg.num_pages} pages, "
                    f"{len(self.recs)} requests)")
        if not all(r.state == FINISHED for r in self.recs.values()):
            raise RuntimeError("kvpool scheduler exceeded max_steps")
        # end-of-trace drain: the radix cache's page references go last
        self.pool.release_prefix_cache()
        return outputs, self.stats
