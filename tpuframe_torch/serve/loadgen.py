"""Open-loop synthetic load generator (counterpart of
``tpuframe/serve/loadgen.py``).

Arrivals are a seeded Poisson process on a virtual clock advanced once per
scheduler step, so the *schedule* is deterministic; TTFT and TPOT are
measured on the host clock by the scheduler.  Every engine call that
returns tokens copies them to the host, so the host clock covers the
device's work.
"""

from __future__ import annotations

import random
import time

import torch

from tpuframe_torch.serve.scheduler import Request, Scheduler


def synthetic_requests(n: int, *, buckets, rate: float = 2.0,
                       max_new_tokens: int = 8, vocab_size: int = 256,
                       seed: int = 0) -> list:
    """``n`` requests with Poisson inter-arrival times (virtual seconds)
    and prompt lengths drawn per bucket — every bucket gets traffic,
    ragged lengths included."""
    rng = random.Random(seed)
    out = []
    t = 0.0
    buckets = tuple(sorted(buckets))
    for rid in range(n):
        t += rng.expovariate(rate)
        bucket = buckets[rid % len(buckets)]
        lo = 1 if bucket == buckets[0] else buckets[
            buckets.index(bucket) - 1] + 1
        length = rng.randint(lo, bucket)
        prompt = [rng.randrange(vocab_size) for _ in range(length)]
        out.append(Request(rid=rid, prompt=prompt,
                           max_new_tokens=max_new_tokens, arrival_t=t))
    return out


def run_loadgen(engine, requests, *, max_steps: int = 10_000,
                steps_per_virtual_s: float = 50.0, log=None) -> dict:
    """Drive a :class:`Scheduler` with an open-loop arrival schedule until
    every request completes (or ``max_steps`` trips).  Returns summary
    stats."""
    sched = Scheduler(engine)
    todo = sorted(requests, key=lambda r: r.arrival_t)
    t_wall0 = time.monotonic()
    virtual_t = 0.0
    i = 0
    steps = 0
    while (i < len(todo) or sched.has_work()) and steps < max_steps:
        while i < len(todo) and todo[i].arrival_t <= virtual_t:
            req = todo[i]
            req.arrival_t = time.monotonic()  # the scheduler's clock
            sched.submit(req)
            i += 1
        if sched.has_work():
            sched.step()
            virtual_t += 1.0 / steps_per_virtual_s
            steps += 1
        else:
            # Idle gap: jump straight to the next arrival.
            virtual_t = todo[i].arrival_t
    wall_s = time.monotonic() - t_wall0

    completed = sched.completed
    total_tokens = sum(len(r.tokens) for r in completed)
    tokens_per_s = total_tokens / wall_s if wall_s > 0 else 0.0
    n_devices = max(1, torch.cuda.device_count())
    stats = {
        "requests": len(completed),
        "submitted": i,
        "unfinished": i - len(completed),
        "steps": sched.step_count,
        "wall_s": round(wall_s, 3),
        "total_tokens": total_tokens,
        "tokens_per_s": round(tokens_per_s, 2),
        "tokens_per_s_per_chip": round(tokens_per_s / n_devices, 2),
        "n_devices": n_devices,
    }
    if log:
        log(f"loadgen: {stats['requests']} requests, "
            f"{stats['total_tokens']} tokens in {stats['wall_s']}s "
            f"({stats['tokens_per_s']} tok/s)")
    return stats
