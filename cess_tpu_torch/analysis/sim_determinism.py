"""Determinism analyzers for the simulation harness (sim/).

The sim package's whole contract is bit-identical replay: every run
of a (seed, scenario) pair must produce the same event order, the
same finalized prefixes, the same SLO transitions. One stray wall
clock read or ``random`` draw breaks that silently — the replay tests
would flake instead of fail. These rules make the contract static:

- sim-wallclock : time.time/monotonic/perf_counter — AND time.sleep,
                  which is worse than nondeterministic in a sim: it
                  blocks the host for virtual-time that SimClock
                  should absorb
- sim-entropy   : random.* / np.random.* / os.urandom / uuid / secrets
                  — all entropy must come from SHA-256 streams over
                  the world seed (the ``_u64`` idiom)

The family also covers the flight recorder's retention-decision code
(obs/flight.py + obs/incident.py), the fleet plane
(obs/fleet.py), the profile plane (obs/profile.py)
and the chain plane (obs/chainwatch.py): "same
seed retains the same traces, bundles the same incidents, federates
the same fleet witness, profiles the same counters and logs the same
chain anomalies" is the identical replay contract, so a wall-clock
read or entropy draw in a pin decision, a scrape round or a watchdog
window is the same class of bug as one in a sim world. (The profile plane's
timings are measured by its serve-layer CALLERS and passed in — the
module itself never touches a clock.)
"""
from __future__ import annotations

import ast

from .core import Finding, ParsedModule, Rule, dotted, path_parts, register

_WALLCLOCK = {"time.time", "time.time_ns", "time.monotonic",
              "time.monotonic_ns", "time.perf_counter",
              "time.perf_counter_ns", "time.sleep",
              "datetime.now", "datetime.utcnow",
              "datetime.datetime.now", "datetime.datetime.utcnow"}
_ENTROPY = {"os.urandom", "uuid.uuid4", "uuid.uuid1"}
_ENTROPY_PREFIXES = ("random.", "np.random.", "numpy.random.",
                     "secrets.")


class _SimRule(Rule):
    def applies(self, path: str) -> bool:
        parts = path_parts(path)
        if "sim" in parts:
            return True
        # the regenerating repair plane: its coefficient
        # and matrix constructions feed the repair storm's replay
        # contract, so a clock read or entropy draw there would break
        # bit-identical replays just like one inside sim/
        # ops/xor_sched.py + ops/rs_xor.py: the schedule
        # witness is canonical bytes — same matrix, byte-identical
        # program on every host — so wallclock/entropy/dict-order
        # anywhere in compile or execute breaks that contract
        if "ops" in parts and parts[-1] in ("regen.py", "xor_sched.py",
                                            "rs_xor.py"):
            return True
        # the remediation plane's action journal is part of the replay
        # witness (same seed => byte-identical action log), so it is
        # held to the sim contract: decisions advance on observation
        # count only, never a clock read or an entropy draw
        if "serve" in parts and parts[-1] == "remediate.py":
            return True
        # the retention layer, the fleet plane, the profile plane,
        # the chain plane and the custody plane make seeded decisions
        # under the same replay contract as sim worlds (the custody
        # ledger log + margin fold is the eighth witness stream)
        return "obs" in parts and parts[-1] in ("flight.py",
                                                "incident.py",
                                                "fleet.py",
                                                "profile.py",
                                                "chainwatch.py",
                                                "custody.py")


@register
class SimWallclock(_SimRule):
    id = "sim-wallclock"
    description = ("wall-clock read or blocking sleep in the "
                   "simulation harness")
    hint = ("use the world's SimClock (now()/sleep()) or schedule an "
            "EventQueue event — virtual time must be the only time "
            "the sim observes")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Attribute):
                continue
            fq = dotted(node)
            if fq in _WALLCLOCK:
                out.append(self.finding(
                    mod, node,
                    f"`{fq}` reads (or blocks on) the wall clock in "
                    "the deterministic sim"))
        return out


@register
class SimEntropy(_SimRule):
    id = "sim-entropy"
    description = "OS / library entropy source in the simulation harness"
    hint = ("derive every draw from a SHA-256 stream over the world "
            "seed (world.u64/_u64), so the same seed replays the "
            "same world")

    def check(self, mod: ParsedModule) -> list[Finding]:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Attribute):
                continue
            fq = dotted(node)
            if fq is None:
                continue
            if fq in _ENTROPY or fq.startswith(_ENTROPY_PREFIXES):
                out.append(self.finding(
                    mod, node,
                    f"`{fq}` is fresh entropy — a same-seed replay "
                    "would diverge"))
        return out
