"""Knowledge freshness subsystem (DESIGN.md §11).

The cache's correctness story has three legs. Two already exist — the
semantic judge (is this *the same question*?) and staticity-derived TTLs
(how long is the answer *expected* to hold?). This module adds the third:
what happens when the world actually changes under a cached value.

Three cooperating pieces, mechanism split from policy:

* :class:`ChangeFeed` — the ORIGIN side. It walks a
  :class:`~repro_torch.data.world.MutableWorld`'s deterministic update schedule
  and broadcasts one notice per (intent, update) to every subscriber,
  each delayed by that subscriber's one-way WAN latency. Intents are
  watched lazily (first cache admission starts the per-intent timer), so
  the event count is bounded by *cached* knowledge, not world size. The
  per-subscriber delay IS the eventual-consistency window: between the
  origin update and notice arrival a region may serve the stale value,
  exactly like a real invalidation bus.

* :class:`FreshnessManager` — one per region/cache. It applies policy on
  two triggers:

  - **change-feed notice** — every cached entry for the updated intent
    (both tiers) is stale. Provenance decides who revalidates:
    federated copies (``se.origin`` set) and warm/cold entries are
    DROPPED — the region that originally fetched the value refreshes its
    own copy, siblings re-lease later (one origin refetch per datum
    fleet-wide instead of one per replica). A hot, locally-fetched entry
    with enough validated hits is REFRESHED in place instead of dropped.
  - **refresh-ahead timer** — hot entries are revalidated shortly before
    TTL expiry instead of being purged, so a popular entry's lifetime is
    a sequence of cheap renewals rather than a miss storm at every TTL
    boundary. Entries that stopped earning hits simply expire.

  Refreshes go through the region's own rate-limited
  :class:`~repro_torch.serving.remote.RemoteDataService` (they cost real
  money and tokens — ``refresh_cost`` is reported) and are skipped when
  limiter headroom is low, so revalidation never starves demand traffic.

* **Versioned SEs** — ``SEStore`` rows carry ``version`` (origin
  knowledge version at fetch) and ``fetched_at``; a refresh bumps both
  in place, preserving row/se_id/freq so live views survive. The engine
  compares a hit's version against the world's current one to count
  ``stale_hits`` and the staleness-age histogram.

Everything runs on the shared :class:`~repro_torch.serving.clock.VirtualClock`,
so multi-region invalidation interleavings are deterministic and
same-seed runs are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.cache import CortexCache
from repro_torch.obs.trace import BACKGROUND, NULL_TRACER


@dataclasses.dataclass
class FreshnessConfig:
    invalidation: bool = True      # subscribe to the origin change feed
    refresh_ahead: bool = True     # revalidate instead of drop/expire
    refresh_margin: float = 0.15   # fraction of TTL left when refresh fires
    # validated hits SINCE THE LAST (re)fetch required to be worth a
    # renewal — lifetime freq would renew dead entries forever
    refresh_min_freq: int = 1
    refresh_min_headroom: float = 0.25  # skip refresh under limiter pressure
    feed_delay: float = 0.15       # one-way origin->region notice latency


@dataclasses.dataclass
class FreshnessStats:
    notices: int = 0           # change-feed notices received
    stale_found: int = 0       # cached entries a notice found outdated
    invalidated: int = 0       # ... dropped (federated/warm/cold entries)
    refreshes: int = 0         # in-place revalidations completed
    refresh_cost: float = 0.0  # origin spend on revalidation fetches
    refresh_skipped: int = 0   # refreshes foregone (headroom / in flight)


class ChangeFeed:
    """Origin-side update feed over a mutable world's schedule.

    One pending clock event per *watched* intent at a time: when it
    fires, notices fan out (per-subscriber WAN delay) and the next
    update event for that intent is scheduled — unless no subscriber
    still holds the intent (its ``interest`` predicate), in which case
    the watch lapses and the next admission re-arms it, so feed work is
    bounded by *live cached* knowledge, not by everything ever cached.
    ``watch`` is idempotent and lazy — a static intent (``next_update``
    = inf) never schedules. Versions are counted per fire (one fire per
    scheduled update, since ``next_update`` strictly advances), not
    re-derived from the float schedule: at an exact update instant the
    floor in ``intent_version`` can land one step short, and a
    short-by-one notice would no-op the whole fan-out.
    """

    def __init__(self, world, clock):
        self.world = world
        self.clock = clock
        # (callback(intent, version, t_update), one-way delay,
        #  interest(intent) -> bool or None = always interested)
        self._subs: list[tuple[Callable, float, Optional[Callable]]] = []
        self._watched: set[int] = set()
        self._version: dict[int, int] = {}  # last version announced
        self.events = 0

    def subscribe(self, callback: Callable, delay: float,
                  interest: Optional[Callable] = None) -> None:
        self._subs.append((callback, float(delay), interest))

    def watch(self, intent: Optional[int]) -> None:
        if intent is None or intent in self._watched:
            return
        intent = int(intent)
        t_next = self.world.next_update(intent, self.clock.now)
        if t_next == float("inf"):
            return
        self._watched.add(intent)
        # (re)sync the counter: updates that elapsed while unwatched
        # notified nobody, but nobody held the intent then either
        self._version[intent] = max(
            self._version.get(intent, 0),
            self.world.intent_version(intent, self.clock.now),
        )
        self.clock.push(t_next, self._fire, intent, t_next)

    def _fire(self, intent: int, t_update: float) -> None:
        self.events += 1
        version = self._version[intent] = self._version[intent] + 1
        for cb, delay, _ in self._subs:
            self.clock.push(t_update + delay, cb, intent, version, t_update)
        if any(i is None or i(intent) for _, _, i in self._subs):
            t_next = self.world.next_update(intent, t_update)
            self.clock.push(t_next, self._fire, intent, t_next)
        else:
            self._watched.discard(intent)  # next admission re-watches


class FreshnessManager:
    """Per-region freshness policy over one cache + origin service."""

    def __init__(self, *, cache: CortexCache, remote, world, clock,
                 cfg: Optional[FreshnessConfig] = None,
                 feed: Optional[ChangeFeed] = None):
        self.cache = cache
        self.remote = remote
        self.world = world
        self.clock = clock
        self.cfg = cfg or FreshnessConfig()
        self.feed = feed
        self.stats = FreshnessStats()
        self._inflight: set[int] = set()
        self._tracer = NULL_TRACER
        self._region = 0
        # §17 overload seam: an armed OverloadController may pause
        # refresh-ahead under limiter-headroom / SLO pressure. None =
        # legacy behavior, bit-identical.
        self.overload = None
        if feed is not None and self.cfg.invalidation:
            # interest predicate lets the feed stop firing for intents
            # this cache no longer holds (O(1) via the intent index)
            feed.subscribe(self._on_notice, self.cfg.feed_delay,
                           interest=cache.has_intent)
        if self.cfg.refresh_ahead:
            # promotions re-enter HOT without passing the engine's
            # insert hook — re-arm their refresh-ahead timers here
            cache.on_promote = self._on_promote

    def bind_tracer(self, tracer, region: int = 0) -> None:
        """Arm §15 tracing: refresh fetches emit background spans,
        invalidation drops emit background markers. Observational only —
        no virtual-time effect."""
        self._tracer = tracer
        self._region = region

    # ------------------------------------------------------------ hooks

    def on_insert(self, se) -> None:
        """Admission hook (every insert path: miss fill, prefetch,
        federated transfer): start watching the intent's change feed and
        arm the refresh-ahead timer."""
        if self.feed is not None and self.cfg.invalidation:
            self.feed.watch(se.intent)
        # no timer for federated copies: provenance says the source
        # region revalidates, so the tick would be a guaranteed no-op
        if self.cfg.refresh_ahead and se.origin is None:
            self._schedule_refresh(se.se_id, se.expires_at)

    def _on_promote(self, se) -> None:
        """A warm entry re-entered HOT (cache.on_promote): its previous
        timer died during the warm sojourn — arm a fresh one."""
        if se.origin is None:
            self._schedule_refresh(se.se_id, se.expires_at)

    # ----------------------------------------------------- invalidation

    def _on_notice(self, intent: int, version: int, t_update: float) -> None:
        """Change-feed notice arrived (``feed_delay`` after the origin
        update): fan out over every cached entry of that intent."""
        self.stats.notices += 1
        now = self.clock.now
        for se in self.cache.ses_for_intent(intent):
            if se.version >= version:
                continue  # already refreshed past this update
            self.stats.stale_found += 1
            refreshable = (
                self.cfg.refresh_ahead
                and getattr(se, "tier", "hot") == "hot"
                # provenance: only the region that fetched from the
                # origin revalidates; federated copies drop and re-lease
                and se.origin is None
                and se.freq - se.freq_at_fetch >= self.cfg.refresh_min_freq
            )
            # mark_stale: this value is KNOWN outdated — keep the row
            # (freq/embedding/LCFU standing survive) but stop serving it
            # until the refetch lands, unlike the TTL-triggered refresh
            # where the value is still presumed fresh
            if refreshable and self._start_refresh(se.se_id,
                                                   mark_stale=True):
                continue
            self.cache.invalidate_se(se.se_id, now)
            self.stats.invalidated += 1
            self._tracer.marker(BACKGROUND, "invalidation_drop", now,
                                self._region)

    # ---------------------------------------------------- refresh-ahead

    def _schedule_refresh(self, se_id: int, expires_at: float) -> None:
        """Arm one revalidation event shortly before this expiry. The
        armed expiry is passed along so a timer armed for a PREVIOUS
        lifetime (entry since renewed, or row re-used by a different
        lifecycle) fires as a no-op."""
        now = self.clock.now
        t = expires_at - self.cfg.refresh_margin * max(expires_at - now, 0.0)
        if t <= now:
            return
        self.clock.push(t, self._refresh_tick, se_id, expires_at)

    def _refresh_tick(self, se_id: int, armed_expiry: float) -> None:
        row = self.cache.soa.id2row.get(se_id)
        if row is None:
            return  # evicted / demoted / invalidated meanwhile
        if float(self.cache.soa.expires_at[row]) != armed_expiry:
            return  # renewed since this timer was armed
        se = self.cache.store[se_id]
        # "earning its keep" = hits since the LAST renewal, not lifetime
        # freq — otherwise one early hit buys perpetual renewals
        if se.origin is not None or \
                se.freq - se.freq_at_fetch < self.cfg.refresh_min_freq:
            return  # not ours to revalidate / not earning its keep
        self._start_refresh(se_id)

    def _start_refresh(self, se_id: int, *, mark_stale: bool = False) -> bool:
        """Kick one origin revalidation fetch. A TTL-triggered refresh
        (``mark_stale=False``) keeps serving the current value — it is
        still presumed fresh, the fetch merely renews it. A
        notice-triggered refresh marks the row ``revalidating``: the
        value is known stale, so stage 1 stops offering it until the
        fetch lands."""
        if se_id in self._inflight:
            self.stats.refresh_skipped += 1
            if mark_stale:
                self.cache.store[se_id].revalidating = True
            return True  # a refresh is already on its way
        now = self.clock.now
        if self.remote.headroom(now) < self.cfg.refresh_min_headroom:
            self.stats.refresh_skipped += 1
            return False
        if self.overload is not None and not self.overload.allow_refresh(
                self.remote.headroom(now), now):
            # §17: refresh-ahead paused under overload pressure
            self.stats.refresh_skipped += 1
            return False
        key = self.cache.store[se_id].key
        if mark_stale:
            self.cache.store[se_id].revalidating = True
        self._inflight.add(se_id)
        out = self.remote.fetch(
            now,
            latency_mult=self.world.latency_mult(key),
            cost_mult=self.world.cost_mult(key),
        )
        if out.failed:
            # origin brownout (§17): the revalidation fetch died — the
            # entry simply stays as-is (possibly marked revalidating);
            # a later notice/TTL timer will try again
            self._inflight.discard(se_id)
            self.stats.refresh_skipped += 1
            return False
        self.stats.refresh_cost += out.cost
        self._tracer.span(BACKGROUND, "refresh", now, out.finish,
                          self._region)
        self.clock.push(out.finish, self._refresh_done, se_id, key)
        return True

    def _refresh_done(self, se_id: int, key: str) -> None:
        self._inflight.discard(se_id)
        now = self.clock.now
        se = self.cache.refresh_entry(
            se_id,
            value=self.world.fetch(key, now),
            version=self.world.version_at(key, now),
            now=now,
        )
        if se is None:
            return  # left the hot tier while the fetch was in flight
        self.stats.refreshes += 1
        if self.cfg.refresh_ahead:
            self._schedule_refresh(se_id, se.expires_at)
