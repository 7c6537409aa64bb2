"""Host-side double-buffered event prefetcher.

The reference has no pipeline parallelism at all — its stages are
*temporal* CLI processes (run_gnn_trackml_mod.sh:71-148) and events are
ingested one at a time, serially, before any compute starts
(event_conversion.py:15-123).  Here the analog (SURVEY section 2.3 "PP"
row) is stage FUSION on device plus a host loader that overlaps the
ingest + host->device transfer of event i+1 with the device compute of
event i: while the device runs the fused pipeline, a background thread
loads the next event (snapshot, CSVs or a toy event), builds
the padded arrays, and issues the jax.device_put — which is itself
asynchronous, so by the time the driver asks for the next GraphState its
arrays are already resident.

Usage:

    it = prefetch(factories, depth=2)
    for g in it:                      # g is device-resident
        run_pipeline(g, cfg)

where each factory is a zero-arg callable returning a GraphState (or any
pytree of arrays).  Exceptions inside a factory propagate to the caller
at the corresponding iteration, preserving order.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Callable, Iterable, Iterator, Sequence

import jax


def _materialize(factory: Callable):
    """Run one factory and start the async host->device transfer."""
    state = factory()
    # device_put is async: it enqueues the copy and returns immediately,
    # so the transfer of event i+1 rides alongside event i's compute.
    return jax.device_put(state)


def prefetch(factories: Iterable[Callable], depth: int = 2,
             workers: int = 1) -> Iterator:
    """Yield device-resident pytrees from `factories`, loading up to
    `depth` events ahead on `workers` background threads.

    depth=2 is classic double buffering: one event on device computing,
    one being ingested/transferred behind it.  Order is preserved; a
    factory that raises re-raises at its position in the stream.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    it = iter(factories)
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        pending: collections.deque = collections.deque()
        try:
            for f in it:
                # drain before submitting so at most `depth` events are
                # ever in flight (submitting first would hold depth+1)
                if len(pending) >= depth:
                    yield pending.popleft().result()
                pending.append(pool.submit(_materialize, f))
            while pending:
                yield pending.popleft().result()
        finally:
            for fut in pending:
                fut.cancel()


def prefetch_trackml(events: Sequence, cfg, dtype=None,
                     depth: int = 2, cache_dir=None,
                     with_tracker: bool = True,
                     workers: int = 1) -> Iterator:
    """Prefetch TrackML events (data/trackml.load_event): snapshot names
    or TrackMLPaths of CSV files, the latter parsed by the native C++
    loader when it builds and optionally cached (cache_dir,
    data/event_cache.py); the ingest of event i+1 overlaps event i's
    device compute."""
    from gnn_track_finding.data import trackml

    def make(ev):
        return lambda: trackml.load_event(ev, cfg, dtype=dtype,
                                          cache_dir=cache_dir,
                                          with_tracker=with_tracker)[0]

    return prefetch([make(ev) for ev in events], depth=depth,
                    workers=workers)
