"""Fleet request routing: prefix/session affinity + pressure feedback.

The router fronts N engine replicas (live ``ServingSystem``s or DES
``ServingModel``s — anything that can produce a
``Scheduler.pressure_stats()`` snapshot) and decides, per request, which
replica admits it.  Three policies:

``round-robin``
    Pure redistribution, ignores all state.  This is the conformance
    baseline: a fleet routed round-robin must equal independently fed
    replicas (tests/test_fleet_conformance.py).

``p2c``
    Weighted power-of-two-choices: sample two replicas, send to the one
    with the lower ``load = (1 + queue + occupancy) * (1 + kv_pressure)``.
    Replicas with zero free KV blocks are ineligible while any
    alternative exists — a router must never knowingly route into
    guaranteed preemption.

``affinity``
    Probe the prompt's leading block chain keys against each replica's
    prefix-cache summary and send to the replica with the longest
    consecutive hit run — unless that replica is *drowning* (pressure
    above ``pressure_high``), in which case affinity yields to p2c over
    the healthy set until the replica recovers below ``pressure_low``
    (hysteresis, so routing doesn't flap at the boundary).  Session
    stickiness covers the first request of a follow-up turn whose blocks
    are not yet registered.

Two summaries are probed per replica, unioned:

* the **authoritative** bloom riding the replica's last
  ``PressureStats.prefix_summary`` snapshot (what the scheduler's
  BlockManager really holds — may lag by the snapshot interval), and
* the router's own **optimistic** bloom of every prefix it has already
  dispatched there (covers the window before the replica computes and
  registers those blocks).

Both are blooms: false positives allowed (worst case: a routed request
re-prefills, correctness unaffected), false negatives never at build
time.  Entries are never removed, so a long-lived optimistic bloom decays
toward "everything matches"; ``FleetRouter`` rebuilds it from scratch
every ``summary_rebuild`` dispatches per replica.

Copied from ``src/repro/fleet/router.py``, with its imports rewritten to
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.serving.blocks import chain_key
from repro_torch.serving.scheduler import PressureStats

POLICIES = ("round-robin", "p2c", "affinity")


def leading_block_keys(tokens: Sequence[int], block_size: int,
                       max_blocks: int = 8) -> List[int]:
    """Chain keys of the prompt's leading full blocks — the same hash
    chain ``BlockManager`` registers, so a key hit means the replica
    (probably) holds that exact prefix block."""
    keys: List[int] = []
    key = 0
    limit = min(len(tokens) - block_size, (max_blocks - 1) * block_size)
    for i in range(0, limit + 1, block_size):
        key = chain_key(key, tokens[i:i + block_size])
        keys.append(key)
    return keys


class PrefixSummary:
    """Bloom filter over prefix-cache chain keys.

    A plain int bitmask (cheap to pickle onto a stats queue, cheap to
    union).  Hash mixing uses CPython's ``hash`` on ``(salt, key)``
    tuples, which is deterministic for ints regardless of
    ``PYTHONHASHSEED`` — summaries built in an engine process match
    probes computed in the router process.

    Invariant: ``might_contain(k)`` is True for every ``k`` ever
    ``add``-ed (no false negatives); spurious True for other keys at a
    rate governed by ``n_bits`` vs. population (false positives only
    degrade routing, never correctness).
    """

    __slots__ = ("n_bits", "n_hashes", "bits", "n_keys")

    def __init__(self, n_bits: int = 4096, n_hashes: int = 3):
        self.n_bits = n_bits
        self.n_hashes = n_hashes
        self.bits = 0
        self.n_keys = 0

    @classmethod
    def from_keys(cls, keys: Sequence[int], n_bits: int = 4096,
                  n_hashes: int = 3) -> "PrefixSummary":
        s = cls(n_bits, n_hashes)
        for k in keys:
            s.add(k)
        return s

    def add(self, key: int) -> None:
        for salt in range(self.n_hashes):
            self.bits |= 1 << (hash((salt, key)) % self.n_bits)
        self.n_keys += 1

    def might_contain(self, key: int) -> bool:
        for salt in range(self.n_hashes):
            if not (self.bits >> (hash((salt, key)) % self.n_bits)) & 1:
                return False
        return True

    def union(self, other: "PrefixSummary") -> "PrefixSummary":
        assert (self.n_bits, self.n_hashes) == (other.n_bits,
                                                other.n_hashes), \
            "cannot union summaries with different geometry"
        out = PrefixSummary(self.n_bits, self.n_hashes)
        out.bits = self.bits | other.bits
        out.n_keys = self.n_keys + other.n_keys
        return out

    def __len__(self) -> int:
        return self.n_keys


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    policy: str = "affinity"            # round-robin | p2c | affinity
    block_size: int = 64                # must match SchedulerConfig
    max_probe_blocks: int = 8           # leading blocks hashed per prompt
    pressure_high: float = 0.85         # affinity yields above this...
    pressure_low: float = 0.60          # ...until back below this
    queue_norm: float = 32.0            # queue depth mapping to pressure 1.0
    summary_bits: int = 4096
    summary_rebuild: int = 512          # optimistic-bloom rebuild period
    session_affinity: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown routing policy {self.policy!r}; "
                             f"expected one of {POLICIES}")
        if self.pressure_low > self.pressure_high:
            raise ValueError("hysteresis band inverted: "
                             "pressure_low > pressure_high")


class FleetRouter:
    """Routes requests across ``n_replicas`` under ``RouterConfig.policy``.

    ``stats_fns[i]`` (optional) returns replica *i*'s latest
    ``PressureStats`` or None; without it the router falls back to its own
    dispatch bookkeeping (in-flight counts) for load decisions.

    Bookkeeping contract: every dispatched request id is recorded with
    ``record_dispatch`` and leaves via exactly one of ``record_done``,
    ``record_abort``, or a replica ``drain``.  Invariant (property-tested):
    ``sum(inflight) == len(outstanding)`` at all times — the router can
    neither leak nor double-count a request across replica drains.
    """

    def __init__(self, n_replicas: int, cfg: RouterConfig = RouterConfig(),
                 stats_fns: Optional[
                     List[Callable[[], Optional[PressureStats]]]] = None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if stats_fns is not None and len(stats_fns) != n_replicas:
            raise ValueError("need one stats_fn per replica")
        self.n = n_replicas
        self.cfg = cfg
        self.stats_fns = stats_fns
        self._rr = 0
        self._rnd = random.Random(cfg.seed)
        # request bookkeeping
        self._outstanding: Dict[int, int] = {}      # rid -> replica idx
        self._inflight = [0] * n_replicas
        # hysteresis state: replicas currently considered drowning
        self._drowning: Set[int] = set()
        # replicas taken out of rotation by drain() (scale-down): route()
        # never picks one while any alternative exists
        self._drained: Set[int] = set()
        # session -> replica stickiness
        self._sessions: Dict[object, int] = {}
        # optimistic summaries of prefixes dispatched per replica
        self._optimistic = [PrefixSummary(cfg.summary_bits)
                            for _ in range(n_replicas)]
        self._dispatched_since_rebuild = [0] * n_replicas
        # counters (surfaced in stats())
        self.n_routed = 0
        self.n_affinity_hits = 0
        self.n_session_hits = 0
        self.n_pressure_diversions = 0

    # -- pressure ------------------------------------------------------------

    def _snapshots(self) -> List[Optional[PressureStats]]:
        if self.stats_fns is None:
            return [None] * self.n
        return [fn() for fn in self.stats_fns]

    def pressure(self, s: Optional[PressureStats], idx: int) -> float:
        """Scalar pressure in [0, 1]: the worst of KV pressure, queue
        depth (normalized), and CPU saturation — any one of them alone
        can drown a replica."""
        if s is None:
            return min(1.0, self._inflight[idx] / self.cfg.queue_norm)
        return max(s.kv_pressure,
                   min(1.0, s.queue_depth / self.cfg.queue_norm),
                   s.cpu_saturation)

    def _refresh_drowning(self,
                          snaps: List[Optional[PressureStats]]) -> None:
        for i in range(self.n):
            p = self.pressure(snaps[i], i)
            if i in self._drowning:
                if p <= self.cfg.pressure_low:
                    self._drowning.discard(i)
            elif p >= self.cfg.pressure_high:
                self._drowning.add(i)

    def _eligible(self, snaps: List[Optional[PressureStats]]) -> List[int]:
        """Replicas with allocatable KV; all of them when none qualify
        (routing somewhere beats dropping the request)."""
        ok = [i for i in range(self.n)
              if snaps[i] is None or snaps[i].free_blocks > 0]
        return ok or list(range(self.n))

    def _load(self, s: Optional[PressureStats], idx: int) -> float:
        if s is None:
            return float(self._inflight[idx])
        # SLO tie-break (docs/slo.md): a replica missing first-token
        # deadlines for its protected classes looks up to 2x as loaded,
        # so ties (and near-ties) drain toward replicas that are actually
        # attaining.  slo_miss_rate() is 0.0 without class data, leaving
        # class-blind fleets bit-identical.
        return ((1.0 + s.queue_depth + s.occupancy)
                * (1.0 + s.kv_pressure)
                * (1.0 + s.slo_miss_rate()))

    def _p2c(self, candidates: List[int],
             snaps: List[Optional[PressureStats]]) -> int:
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rnd.sample(candidates, 2)
        la, lb = self._load(snaps[a], a), self._load(snaps[b], b)
        return a if la <= lb else b

    # -- affinity ------------------------------------------------------------

    def _affinity_scores(self, keys: List[int],
                         snaps: List[Optional[PressureStats]]) -> List[int]:
        """Per replica: consecutive leading-block hits against the union
        of its snapshot summary and the router's optimistic summary."""
        scores = []
        for i in range(self.n):
            snap_sum = snaps[i].prefix_summary if snaps[i] is not None \
                else None
            score = 0
            for k in keys:
                hit = self._optimistic[i].might_contain(k) or (
                    snap_sum is not None and snap_sum.might_contain(k))
                if not hit:
                    break
                score += 1
            scores.append(score)
        return scores

    def _note_dispatch_prefix(self, idx: int, keys: List[int]) -> None:
        self._dispatched_since_rebuild[idx] += 1
        if self._dispatched_since_rebuild[idx] > self.cfg.summary_rebuild:
            # decay: a bloom only accretes; rebuilding from nothing lets
            # evicted prefixes eventually stop attracting traffic
            self._optimistic[idx] = PrefixSummary(self.cfg.summary_bits)
            self._dispatched_since_rebuild[idx] = 0
        for k in keys:
            self._optimistic[idx].add(k)

    # -- routing -------------------------------------------------------------

    def route(self, prompt_tokens: Sequence[int],
              session: Optional[object] = None,
              exclude: Sequence[int] = ()) -> int:
        """Pick a replica for a prompt.  ``session`` keys stickiness;
        ``exclude`` removes replicas from consideration (fleet-level retry
        after a timeout must not go back to the replica that starved)."""
        self.n_routed += 1
        excluded = set(exclude) | self._drained
        if len(excluded) >= self.n:
            # every replica excluded: drop the drain exclusions first
            # (routing somewhere beats dropping the request), then the
            # caller's if even that leaves nothing
            excluded = set(exclude)
            if len(excluded) >= self.n:
                excluded = set()

        if self.cfg.policy == "round-robin":
            for _ in range(self.n):
                idx = self._rr % self.n
                self._rr += 1
                if idx not in excluded:
                    return idx
            return 0  # unreachable: excluded is a strict subset

        snaps = self._snapshots()
        self._refresh_drowning(snaps)
        eligible = [i for i in self._eligible(snaps) if i not in excluded]
        if not eligible:
            eligible = [i for i in range(self.n) if i not in excluded]

        if self.cfg.policy == "p2c":
            return self._p2c(eligible, snaps)

        # affinity
        keys = leading_block_keys(prompt_tokens, self.cfg.block_size,
                                  self.cfg.max_probe_blocks)
        healthy = [i for i in eligible if i not in self._drowning] \
            or eligible
        scores = self._affinity_scores(keys, snaps)
        idx: Optional[int] = None
        best_score = max(scores[i] for i in eligible)
        if best_score > 0:
            # a prefix dispatched to one replica and later diverted lives
            # in BOTH blooms, so score ties are common — break them by
            # load, never by index (a fixed tie-break funnels every
            # dual-resident stream onto one replica and capsizes it)
            cands = [i for i in eligible if scores[i] == best_score]
            healthy_c = [i for i in cands if i in healthy]
            if healthy_c:
                idx = min(healthy_c,
                          key=lambda i: (self._load(snaps[i], i), i))
                self.n_affinity_hits += 1
            else:
                self.n_pressure_diversions += 1
        if idx is None and self.cfg.session_affinity and session is not None:
            sticky = self._sessions.get(session)
            if sticky is not None and sticky in healthy:
                idx = sticky
                self.n_session_hits += 1
        if idx is None:
            idx = self._p2c(healthy, snaps)
        if session is not None:
            self._sessions[session] = idx
        self._note_dispatch_prefix(idx, keys)
        return idx

    # -- bookkeeping ---------------------------------------------------------

    def record_dispatch(self, rid: int, idx: int) -> None:
        assert rid not in self._outstanding, \
            f"request {rid} dispatched twice without completion"
        self._outstanding[rid] = idx
        self._inflight[idx] += 1

    def record_done(self, rid: int) -> Optional[int]:
        """Request finished (or timed out) on its replica; returns the
        replica index, or None if the rid is unknown (already drained)."""
        idx = self._outstanding.pop(rid, None)
        if idx is not None:
            self._inflight[idx] -= 1
        return idx

    record_abort = record_done

    def drain(self, idx: int) -> List[int]:
        """Replica going away: take it out of the rotation (``route``
        never picks a drained replica while any alternative exists, and
        session stickiness to it breaks), forget everything outstanding
        on it, and return the orphaned rids (the caller re-routes or
        fails them — or lets them finish in place: a later
        ``record_done`` for an orphaned rid is a no-op, not a leak)."""
        self._drained.add(idx)
        rids = [r for r, i in self._outstanding.items() if i == idx]
        for r in rids:
            del self._outstanding[r]
        self._inflight[idx] = 0
        return rids

    def undrain(self, idx: int) -> None:
        """Return a drained replica to the rotation (scale-up reusing
        the slot)."""
        self._drained.discard(idx)

    def add_replica(self, stats_fn: Optional[
            Callable[[], Optional[PressureStats]]] = None) -> int:
        """Grow the fleet by one replica (scale-up acting on a
        ``FleetAutoscaler`` recommendation); returns the new index.
        The newcomer starts with empty bookkeeping — zero in-flight, an
        empty optimistic bloom — so load-based policies naturally favor
        it until it warms up."""
        idx = self.n
        self.n += 1
        if stats_fn is not None and self.stats_fns is None:
            self.stats_fns = [(lambda: None) for _ in range(idx)]
        if self.stats_fns is not None:
            self.stats_fns.append(stats_fn if stats_fn is not None
                                  else (lambda: None))
        self._inflight.append(0)
        self._optimistic.append(PrefixSummary(self.cfg.summary_bits))
        self._dispatched_since_rebuild.append(0)
        return idx

    @property
    def outstanding(self) -> Dict[int, int]:
        return dict(self._outstanding)

    def stats(self) -> Dict[str, object]:
        return {
            "policy": self.cfg.policy,
            "n_routed": self.n_routed,
            "n_affinity_hits": self.n_affinity_hits,
            "n_session_hits": self.n_session_hits,
            "n_pressure_diversions": self.n_pressure_diversions,
            "drowning": sorted(self._drowning),
            "drained": sorted(self._drained),
            "inflight": list(self._inflight),
        }
