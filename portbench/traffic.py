"""The one traffic generator: every mix is a data file of parameters.

A cell file (``workloads/<cell>.json``) gives lengths as distributions,
the arrival process, and, for document traffic, the documents. Every seed
gets the same arrival times and the same set of sizes, drawn once from the
file's ``sizes_seed``; ``--seed`` only orders the sizes over the arrivals
and draws the token ids. So two seeds do the same work in another order,
and a change of seed moves a metric only as far as order and ids do.

Distributions (``{"dist": ..., "min": a, "max": b}``, whole numbers,
clipped to [min, max]): ``lognormal`` (``median``, ``sigma``), ``uniform``
(inclusive), ``fixed`` (``value``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def _draw(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    kind = spec["dist"]
    if kind == "lognormal":
        x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    elif kind == "uniform":
        x = rng.integers(spec["min"], spec["max"] + 1, n)
    elif kind == "fixed":
        x = np.full(n, spec["value"])
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(x), spec.get("min", 1),
                   spec.get("max", np.inf)).astype(np.int64)


def _order(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng([int(seed), 1]).permutation(n)


def _ids(seed: int, stream: int, n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng([int(seed), 2, stream]).integers(
        0, vocab, n, dtype=np.int64)


@dataclasses.dataclass
class Request:
    index: int
    prompt: List[int]
    max_tokens: int
    due_s: float = 0.0            # open loop: when it is due, from t0
    doc: Optional[int] = None     # document traffic: which document
    measured: bool = True


def open_loop(mix: dict, seed: int, seconds: float, vocab: int,
              max_len: int, extra_s: float) -> List[Request]:
    """Poisson arrivals at ``rate_hz`` for ``seconds`` (the measured
    requests, ``measured``), after ``ramp_s`` of arrivals that bring the
    replica to its steady load and before ``extra_s`` more that keep it
    there while the measured requests get their first tokens (neither is
    measured). The measured arrivals are ``sizes_seed``'s, scaled so the
    measured requests span the window, the same for every seed; the others
    come every 1 / rate, sized from the same set. Due times are from the
    window's start (the ramp's are negative)."""
    rate = float(mix["rate_hz"])
    n = max(1, int(round(rate * seconds)))
    n_ramp = int(np.ceil(rate * float(mix.get("ramp_s", 0.0))))
    n_extra = int(np.ceil(rate * extra_s))
    base = np.random.default_rng(int(mix["sizes_seed"]))
    gaps = base.exponential(1.0 / rate, n + 1)
    gaps *= seconds / gaps.sum()
    prompt_len = _draw(base, mix["prompt"], n)
    out_len = _draw(base, mix["output"], n)
    order = _order(seed, n)
    due = list(np.cumsum(np.concatenate([[0.0], gaps[1:n]])))
    other = np.random.default_rng([int(seed), 3]).integers(
        0, n, n_ramp + n_extra)
    sizes = list(order) + list(other)
    due += [-(n_ramp - i) / rate for i in range(n_ramp)]
    due += [seconds + i / rate for i in range(n_extra)]
    reqs = []
    for i, j in enumerate(sizes):
        p = int(prompt_len[j])
        reqs.append(Request(
            index=i, prompt=_ids(seed, i, p, vocab).tolist(),
            max_tokens=int(min(out_len[j], max_len - 1 - p)),
            due_s=float(due[i]), measured=i < n))
    return sorted(reqs, key=lambda q: q.due_s)


RAMP_IDS = 10**8      # id streams of the ramp's requests start here


class Documents:
    """Document traffic: ``docs.count`` documents of ``docs.length`` tokens,
    each request one document (Zipf(``docs.zipf``) popularity over their
    ranks) followed by a unique question of ``question`` tokens, asking for
    ``output`` tokens. ``pool`` requests are drawn once from
    ``sizes_seed``, about as many as a window sends. The window's requests
    are the pool in the seed's order (from its start again once used up),
    so every seed's window does the same work; the ramp's are the pool in
    another order. The seed draws every id; no two requests share a
    question's ids."""

    def __init__(self, mix: dict, seed: int, vocab: int, max_len: int):
        base = np.random.default_rng(int(mix["sizes_seed"]))
        d = mix["docs"]
        self.doc_len = _draw(base, d["length"], int(d["count"]))
        self.docs = [_ids(seed, 10**9 + k, int(n), vocab).tolist()
                     for k, n in enumerate(self.doc_len)]
        n = int(mix["pool"])
        ranks = np.arange(1, len(self.docs) + 1, dtype=np.float64)
        pop = ranks ** -float(d["zipf"])
        self.doc_of = base.choice(len(self.docs), n, p=pop / pop.sum())
        self.q_len = _draw(base, mix["question"], n)
        self.out_len = _draw(base, mix["output"], n)
        self.order = _order(seed, n)
        self.ramp_order = np.random.default_rng([int(seed), 4]).permutation(n)
        self.seed, self.vocab, self.max_len = seed, vocab, max_len

    def __len__(self) -> int:
        return len(self.order)

    def request(self, i: int, ramp: bool = False) -> Request:
        """The window's ``i``-th request, or with ``ramp`` the ramp's."""
        order = self.ramp_order if ramp else self.order
        j = order[i % len(order)]
        doc = int(self.doc_of[j])
        stream = RAMP_IDS + i if ramp else i
        prompt = self.docs[doc] + _ids(self.seed, stream, int(self.q_len[j]),
                                       self.vocab).tolist()
        return Request(index=i, prompt=prompt, doc=doc,
                       max_tokens=int(min(self.out_len[j],
                                          self.max_len - 1 - len(prompt))))


def buckets(lengths, max_len: int, floor: int = 8) -> List[int]:
    """The engine's pow-2 prefill buckets that ``lengths`` reach (its
    ``_bucket`` rule: from ``floor`` up, clamped to ``max_len``)."""
    out = set()
    for n in lengths:
        b = floor
        while b < n:
            b *= 2
        out.add(min(b, max_len))
    return sorted(out)
