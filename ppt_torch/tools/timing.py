"""Device time of a call on the card, by CUDA events.

``gpu_time_ms`` times calls back to back between two events;
``queued_ms`` times calls shorter than their launch, queued behind a
sleeping kernel so that the host's time between them does not show.
``chip_smoke.py`` and the probes (``component_probe``, ``backbone_bench``,
``pointnext_profile``) share them. Both need a card.
"""

from __future__ import annotations

import time

import torch


def gpu_time_ms(fn, reps=10, warmup=2):
    """Mean device time per call (CUDA events around `reps` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps=20, sleep_cycles=20_000_000):
    """Device time per call of a kernel shorter than its launch: the calls
    are queued behind a sleeping kernel, so the card runs them back to back
    and the host's time between them does not show. The host must have
    enqueued every call before the sleep (about 10 ms at first) ends; when
    it has not (a long enqueue, or more launches than the card's queue
    holds, which blocks the host), the sleep is doubled, the calls halved
    and the reading taken again. `fn` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(sleep_cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < 0.9 * ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        sleep_cycles *= 2
        reps = max(2, reps // 2)
    raise RuntimeError(f"queued_ms: {reps} queued calls took {host_ms:.1f} ms of host time, "
                       "longer than the sleep they were queued behind")
