"""The one generator that every traffic mix (``fgbench/traffic/*.json``)
drives.

A mix names the program's entry (``run``: one load case a request, or
``run_batched``: several in one batched CG), the load cases, how many go
into a request, their order and its start, and the loop.  Only a closed
loop with one client is defined: the next request is sent when the last
has returned.
"""
from __future__ import annotations

import itertools

ENTRIES = ("run", "run_batched")


def check(traffic: dict):
    if traffic.get("loop") != "closed" or int(traffic.get("clients", 0)) != 1:
        raise ValueError("only a closed loop with one client is defined")
    if traffic["entry"] not in ENTRIES:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    if traffic.get("order") != "cycle":
        raise ValueError(f"unknown order {traffic.get('order')!r}")


def per_request(traffic: dict, n_cases: int) -> int:
    k = traffic["cases_per_request"]
    return n_cases if k == "all" else int(k)


def requests(traffic: dict, n_cases: int, rng):
    """An endless iterator of requests, each a tuple of case indices: the
    cases in turn, from the first (``start: first``) or from one drawn
    from ``rng`` (``start: seed``), ``cases_per_request`` at a time."""
    check(traffic)
    k = per_request(traffic, n_cases)
    if traffic["entry"] == "run" and k != 1:
        raise ValueError("entry 'run' takes one load case a request")
    start = 0 if traffic.get("start") == "first" else int(
        rng.integers(0, n_cases))
    cases = itertools.cycle([(start + i) % n_cases for i in range(n_cases)])
    while True:
        yield tuple(next(cases) for _ in range(k))
