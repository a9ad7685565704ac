"""Liveness heartbeats (the reference's pallet_im_online).

Authorities submit one heartbeat per era
(runtime/src/lib.rs:514-540: ImOnline is in the
session keys and unresponsive validators become offences). Here the
node layer auto-submits a feeless signed heartbeat for each local
authority key once per era (the node layer's network loop and
node/net.py author loop — the OCW analog); at era end, every validator
in the era's exposure set with no heartbeat is reported to the
offences pallet (1% slash).

Network-outage guard: if NO heartbeat at all arrived in an era, the
check is skipped — a chain where nobody could submit (harness without
the node loop, or a full network partition) must not slash everyone. The
reference's im-online is similarly session-gated.
"""
from __future__ import annotations

from .state import DispatchError, State

PALLET = "im_online"


class ImOnline:
    def __init__(self, state: State, staking, offences):
        self.state = state
        self.staking = staking
        self.offences = offences

    def heartbeat(self, who: str) -> None:
        """One per era per authority; duplicates are an error so the
        tx pool / pool admission naturally dedups. Only accounts in
        the era's exposed set (or declared validators) may beat —
        heartbeat is FEELESS, so an open surface would be a free-tx
        spam vector and would defeat the outage guard."""
        era = self.staking.current_era()
        if who not in self.staking.era_validators(era) \
                and who not in self.staking.validators():
            raise DispatchError("im_online.NotAuthority", who)
        if self.state.contains(PALLET, "beat", era, who):
            raise DispatchError("im_online.DuplicateHeartbeat", who)
        self.state.put(PALLET, "beat", era, who, self.state.block)
        self.state.deposit_event(PALLET, "Heartbeat", who=who, era=era)

    def has_beat(self, era: int, who: str) -> bool:
        return self.state.contains(PALLET, "beat", era, who)

    def era_check(self, era: int) -> None:
        """Era rotation hook: report validators exposed in ``era``
        that never heartbeat."""
        beats = [k[0] for k, _ in self.state.iter_prefix(PALLET, "beat",
                                                         era)]
        if not beats:
            return   # outage guard (see module docstring)
        for v in self.staking.era_validators(era):
            if v not in beats:
                self.offences.report_liveness_fault(v, era)
        # prune: this era's beats have been judged
        for (e, who), _ in list(self.state.iter_prefix(PALLET, "beat")):
            if e <= era:
                self.state.delete(PALLET, "beat", e, who)
