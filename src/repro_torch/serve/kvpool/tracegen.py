"""Seeded trace-driven load generation for the kvpool serving benchmarks.

The port's copy of ``repro/serve/kvpool/tracegen.py``: host-only Python, unchanged.

Replaces hand-built request lists with a reproducible model of production
traffic: Poisson arrivals (exponential inter-arrival gaps in scheduler
steps), a pool of prompt *templates* (system prompts / few-shot prefixes)
that a configurable fraction of requests reuse with a fresh per-user suffix
— the prefix-skewed mix the radix pool is built for — plus per-request
priorities and latency SLOs.

Everything is derived from one ``numpy`` generator seeded by
``TraceGenConfig.seed``: the same config always produces byte-identical
prompts, arrival times and priorities, so a trace replayed against pools in
different ``prefix_mode``\\ s isolates exactly the storage discipline
(scheduling is deterministic too — see policy/scheduler tie-breaks).

``latency_summary`` turns a finished trace's :class:`TraceStats` into the
report the benchmarks publish: p50/p99 time-to-first-token and inter-token
latency (in scheduler steps — the unit preemption stretches), and SLO
attainment when the config sets bounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .scheduler import Request, TraceStats


@dataclasses.dataclass(frozen=True)
class TraceGenConfig:
    seed: int = 0
    n_requests: int = 16
    vocab: int = 512
    arrival_rate: float = 1.0           # mean arrivals per scheduler step
    n_templates: int = 2
    template_len: tuple[int, int] = (12, 16)   # inclusive token range
    template_reuse: float = 0.6         # P(request starts from a template)
    suffix_len: tuple[int, int] = (2, 6)       # per-user tokens after template
    n_new: tuple[int, int] = (4, 8)            # decode lengths
    priorities: tuple[int, ...] = (0,)
    ttft_slo: int | None = None         # max acceptable TTFT (steps)
    itl_slo: int | None = None          # max acceptable per-token gap (steps)


def generate(cfg: TraceGenConfig) -> list[Request]:
    """One reproducible request trace: ``n_requests`` timed, prefix-skewed
    requests ordered by arrival."""
    rng = np.random.default_rng(cfg.seed)
    templates = [rng.integers(0, cfg.vocab,
                              (int(rng.integers(cfg.template_len[0],
                                                cfg.template_len[1] + 1)),),
                              dtype=np.int32)
                 for _ in range(cfg.n_templates)]
    reqs = []
    clock = 0.0
    for i in range(cfg.n_requests):
        clock += rng.exponential(1.0 / cfg.arrival_rate)
        suffix = rng.integers(0, cfg.vocab,
                              (int(rng.integers(cfg.suffix_len[0],
                                                cfg.suffix_len[1] + 1)),),
                              dtype=np.int32)
        if rng.random() < cfg.template_reuse:
            prompt = np.concatenate(
                [templates[int(rng.integers(len(templates)))], suffix])
        else:
            fresh = rng.integers(0, cfg.vocab,
                                 (int(rng.integers(cfg.template_len[0],
                                                   cfg.template_len[1] + 1)),),
                                 dtype=np.int32)
            prompt = np.concatenate([fresh, suffix])
        reqs.append(Request(
            req_id=i, tokens=prompt,
            n_new=int(rng.integers(cfg.n_new[0], cfg.n_new[1] + 1)),
            priority=int(rng.choice(np.asarray(cfg.priorities))),
            arrive_at=1 + int(clock)))
    return reqs


def _pct(xs: list[int], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def latency_summary(stats: TraceStats,
                    cfg: TraceGenConfig | None = None) -> dict:
    """p50/p99 TTFT + inter-token latency (scheduler steps) and, when the
    config carries SLOs, the fraction of requests meeting them."""
    ttfts = [t for t in stats.ttft_steps.values() if t is not None]
    itls = [g for gaps in stats.itl_steps.values() for g in gaps]
    out = {
        "ttft_p50": _pct(ttfts, 50), "ttft_p99": _pct(ttfts, 99),
        "itl_p50": _pct(itls, 50), "itl_p99": _pct(itls, 99),
    }
    if cfg is not None and cfg.ttft_slo is not None:
        out["ttft_slo_attained"] = (
            float(np.mean([t <= cfg.ttft_slo for t in ttfts])) if ttfts else 1.0)
    if cfg is not None and cfg.itl_slo is not None:
        per_req = [max(gaps) <= cfg.itl_slo
                   for gaps in stats.itl_steps.values() if gaps]
        out["itl_slo_attained"] = (float(np.mean(per_req)) if per_req else 1.0)
    return out
