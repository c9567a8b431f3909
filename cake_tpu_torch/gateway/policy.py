"""Pluggable request routing over the UP backend set.

Three policies, selected by ``--route-policy``:

- ``p2c`` (default) — power-of-two-choices: sample two backends, send the
  request to the less loaded one (load = outstanding work per slot from
  the ``/healthz`` load fields). Mitzenmacher's result is that this beats
  random assignment exponentially in the max-queue sense while needing
  only two load lookups — no global scan, no coordination;
- ``round_robin`` — strict rotation; the baseline the bench row and the
  prefix-affinity acceptance test compare against;
- ``prefix`` — prefix affinity (the SGLang observation): requests whose
  prompts open with the same ``prefix_block``-aligned tokens hash to the
  same preferred replica via rendezvous hashing, so that replica's engine
  prefix store (``BatchGenerator._prefix_store``) keeps their shared
  prefix KV hot — the per-engine cache becomes a fleet-wide one. A
  saturated preferred replica falls back to p2c over the rest (affinity
  is a throughput optimization, never a queueing obligation).

A policy sees only the candidate list the proxy hands it (UP backends not
yet tried for this request) and returns one of them; the retry loop in
``gateway/api.py`` owns exclusion and exhaustion.
"""

from __future__ import annotations

import hashlib
import random
import threading

from cake_tpu_torch.obs import metrics as obs_metrics

POLICIES = ("p2c", "round_robin", "prefix")

# routing-decision series: how often prefix affinity actually landed on
# the preferred replica vs fell back to p2c (saturation / no key)
PREFIX_HITS = obs_metrics.counter("gateway.route_prefix_hits")
PREFIX_FALLBACK = obs_metrics.counter("gateway.route_prefix_fallback")


def prefix_key(body: dict, block: int) -> bytes | None:
    """The affinity key for one completions body: the FIRST
    ``block``-aligned run of the prompt (token ids, or characters for a
    text prompt the gateway cannot tokenize). ``None`` — a prompt shorter
    than one block, or an unparseable body — means "no preference" and
    routes via p2c.

    One block, not the whole prompt, is the point: requests sharing a
    system prompt but differing in their user tail (and total length)
    must map to the SAME key — and therefore the same replica — for the
    second one to hit the first one's cached prefix KV. The engine's
    store keys are ``prefix_block``-aligned too, so a first-block match
    is exactly the granularity at which the cache can pay off.
    """
    ids = body.get("prompt_ids")
    if (isinstance(ids, list) and len(ids) >= block
            and all(isinstance(t, int) for t in ids)):
        return b"ids:" + ",".join(map(str, ids[:block])).encode()
    prompt = body.get("prompt")
    if isinstance(prompt, str) and len(prompt) >= block:
        return b"txt:" + prompt[:block].encode("utf-8", "replace")
    return None


def _rendezvous(key: bytes, name: str) -> int:
    """Highest-random-weight score of ``key`` on backend ``name``: stable
    across processes (no PYTHONHASHSEED), and removing one backend only
    remaps the keys that preferred it."""
    h = hashlib.sha1(key + b"\x00" + name.encode()).digest()
    return int.from_bytes(h[:8], "big")


class RoundRobin:
    """Strict rotation over the candidate list."""

    name = "round_robin"
    wants_key = False  # the proxy skips body parsing entirely

    _GUARDED_BY = {"_i": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._i = 0

    def choose(self, candidates, key=None, now: float = 0.0,
               first_attempt: bool = True):
        with self._lock:
            i = self._i
            self._i += 1
        return candidates[i % len(candidates)]


class P2C:
    """Power-of-two-choices on the live load signal."""

    name = "p2c"
    wants_key = False

    def __init__(self, rng: random.Random | None = None):
        self._rng = rng or random.Random()

    def choose(self, candidates, key=None, now: float = 0.0,
               first_attempt: bool = True):
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        sat_a, sat_b = a.saturated(now), b.saturated(now)
        if sat_a != sat_b:
            return b if sat_a else a
        la, lb = a.load_score(), b.load_score()
        if la != lb:
            return a if la < lb else b
        return a if self._rng.random() < 0.5 else b


class Prefix:
    """Prefix affinity with p2c fallback."""

    name = "prefix"
    wants_key = True  # the proxy parses the body to derive the key

    def __init__(self, block: int = 64, rng: random.Random | None = None):
        if block < 1:
            raise ValueError(f"prefix block must be >= 1, got {block}")
        self.block = block
        self._p2c = P2C(rng)

    def choose(self, candidates, key=None, now: float = 0.0,
               first_attempt: bool = True):
        if key is None:
            return self._p2c.choose(candidates, now=now)
        preferred = max(candidates,
                        key=lambda b: _rendezvous(key, b.name))
        if preferred.saturated(now) and len(candidates) > 1:
            # affinity never queues behind a full replica: the KV rebuild
            # elsewhere costs less than waiting for the hot one
            if first_attempt:
                PREFIX_FALLBACK.inc()
            rest = [b for b in candidates if b is not preferred]
            return self._p2c.choose(rest, now=now)
        # the routing-decision counters score the FIRST choice only: on a
        # retry the true preferred replica has already been excluded, so
        # landing on the runner-up must not read as an affinity hit
        if first_attempt:
            PREFIX_HITS.inc()
        return preferred


def pick_prefill(candidates, rng: random.Random | None = None):
    """Prefill-tier choice (the disagg two-stage route's first hop):
    least queued work wins — a prefill replica's cost is its prompt
    queue (plus KV transfers still draining), not decoding neighbors,
    so queue depth is the whole signal and p2c's sampled-pair dance
    buys nothing over just reading it. Ties break randomly so equal
    replicas share the load."""
    # snapshot scores once: the probe thread mutates load fields
    # concurrently, and re-reading between min() and the tie filter
    # could leave no backend matching the stale minimum
    scored = [(b.queue_score(), b) for b in candidates]
    best = min(score for score, _ in scored)
    tied = [b for score, b in scored if score == best]
    return (rng or random).choice(tied)


def pick_batch(candidates, rng: random.Random | None = None):
    """Batch-class choice (SLO routing): drain offline traffic
    to the least-loaded replica instead of the affinity pick —
    interactive requests keep prefix affinity and its hot-KV wins, while
    batch floods spread wherever slack is (their TTFT does not matter
    and their slots are the preemption victims). Least outstanding work
    per slot, spilled victims included; ties break randomly."""
    scored = [(b.load_score(), b) for b in candidates]
    best = min(score for score, _ in scored)
    tied = [b for score, b in scored if score == best]
    return (rng or random).choice(tied)


_DECODE_PREFIX = Prefix()


def pick_decode(candidates, key=None, now: float = 0.0,
                rng: random.Random | None = None):
    """Decode-tier choice (the two-stage route's second hop): p2c on the
    live load signal, with prefix affinity when the request carries a
    key — a decode replica's engine prefix store serves imported
    streams too, so same-prefix resumes landing together keep their
    shared pages hot. Delegates to the Prefix policy (tier-scoped), so
    a saturated preferred replica falls back to p2c over the rest and
    the affinity hit/fallback counters cover the tiered route too."""
    policy = Prefix(rng=rng) if rng is not None else _DECODE_PREFIX
    return policy.choose(candidates, key=key, now=now)


def make_policy(name: str, prefix_block: int = 64,
                rng: random.Random | None = None):
    """Policy registry (the ``--route-policy`` values)."""
    if name == "p2c":
        return P2C(rng)
    if name == "round_robin":
        return RoundRobin()
    if name == "prefix":
        return Prefix(prefix_block, rng)
    raise ValueError(
        f"unknown routing policy {name!r} (have {', '.join(POLICIES)})")
