"""The in-process fleet's lease heartbeat under load, on the card.

    python tools/fleet_tick.py [--rounds 2]

Runs chip_smoke.py's phases J1 (one replica owns every pod, bench-50k)
and J2 (a crash failover, bench-50k x 10,000 pods) ``--rounds`` times in
this one process, and watches the ``FleetSupervisor`` tick thread while
they run:

  tick gaps       the time from one tick's start to the next (the tick
                  period is TTL/4, 0.5 s at the default 2 s TTL);
  start age       the age of the oldest lease in store truth as
                  ``FleetSupervisor.start`` returns (its claims predate
                  the engines' informer syncs);
  lease age       at each tick's start, before its renewals, the age of
                  every lease a live replica holds in store truth (now
                  minus ``renewed_at``): a lease reads expired once it
                  passes the TTL (a killed replica's lease is left out:
                  it is meant to expire);
  gc pauses       every collection of the interpreter's cyclic garbage
                  collector longer than 50 ms, by generation (``gc``
                  callbacks): a pause holds every thread, the tick's too.

A phase that fails its check is printed and the run goes on. Prints the
card's name and power limit, then each round's numbers; the last line
is one JSON object with the totals. Needs the card (the engines run on
``cuda:0``).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from minisched_tpu_torch.fleet import supervisor as sup  # noqa: E402

T0 = time.monotonic()
TICKS: list = []    # (start, max lease age before renewal)
STARTS: list = []   # (time, max lease age as FleetSupervisor.start returns)
PAUSES: list = []   # (start, generation, seconds)


def _lease_age(fleet) -> float:
    live = set(fleet.engines())
    now = fleet._clock()
    return max((now - lease.renewed_at for lease in fleet.store.list("Lease")
                if lease.holder in live), default=0.0)


def _watch_ticks() -> None:
    tick, start = sup.FleetSupervisor.tick, sup.FleetSupervisor.start

    def watched_tick(self):
        TICKS.append((time.monotonic() - T0, _lease_age(self)))
        tick(self)

    def watched_start(self):
        start(self)
        STARTS.append((time.monotonic() - T0, _lease_age(self)))

    sup.FleetSupervisor.tick = watched_tick
    sup.FleetSupervisor.start = watched_start


def _watch_gc() -> None:
    state = {}

    def cb(phase, info):
        if phase == "start":
            state["t"] = time.monotonic()
        elif "t" in state:
            d = time.monotonic() - state["t"]
            if d > 0.05:
                PAUSES.append((state["t"] - T0, info["generation"], d))

    gc.callbacks.append(cb)


def _summary(lo: float, hi: float) -> dict:
    ticks = [t for t in TICKS if lo <= t[0] < hi]
    gaps = [b[0] - a[0] for a, b in zip(ticks, ticks[1:])]
    pauses = [p for p in PAUSES if lo <= p[0] < hi]
    starts = [a for t, a in STARTS if lo <= t < hi]
    return {"seconds": hi - lo, "ticks": len(ticks),
            "lease_age_at_start_s": max(starts, default=None),
            "max_tick_gap_s": max(gaps, default=None),
            "max_lease_age_s": max((t[1] for t in ticks), default=None),
            "gc_pauses": len(pauses),
            "gc_pause_s_total": sum(p[2] for p in pauses),
            "gc_pause_s_max": max((p[2] for p in pauses), default=None)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    _watch_ticks()
    _watch_gc()
    rounds = []
    for r in range(args.rounds):
        for name, phase in (("J1", cs.fleet_placement_phase),
                            ("J2", cs.failover_phase)):
            lo = time.monotonic() - T0
            try:
                phase(smi)
                ok = True
            except SystemExit as e:
                print(f"round {r} {name}: {e}")
                ok = False
            row = {"round": r, "phase": name, "ok": ok,
                   **_summary(lo, time.monotonic() - T0)}
            rounds.append(row)
            print(json.dumps(row))
    print(json.dumps({
        "card": smi, "failed": [f"{x['phase']}#{x['round']}"
                                for x in rounds if not x["ok"]],
        "lease_age_at_start_s": max((x["lease_age_at_start_s"] or 0)
                                    for x in rounds),
        "max_tick_gap_s": max((x["max_tick_gap_s"] or 0) for x in rounds),
        "max_lease_age_s": max((x["max_lease_age_s"] or 0)
                               for x in rounds),
        "gc_pause_s_max": max((x["gc_pause_s_max"] or 0) for x in rounds),
        "gc_pause_share": sum(x["gc_pause_s_total"] for x in rounds)
        / sum(x["seconds"] for x in rounds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
