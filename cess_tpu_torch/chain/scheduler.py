"""Named-task block scheduler (reference: pallet-scheduler usage).

file-bank schedules deal timeouts / calculate_end / miner-exit tasks as
named scheduled calls (c-pallets/file-bank/src/lib.rs:102-104,
functions.rs:154-170). Tasks are stored as (pallet, method, args)
descriptors and dispatched by the runtime at their block, root-origin,
best-effort (a failing task is dropped with an event, like FRAME's
scheduler).
"""
from __future__ import annotations

from .state import State

PALLET = "scheduler"


class Scheduler:
    def __init__(self, state: State):
        self.state = state

    def schedule_named(self, name: str, at_block: int, pallet: str,
                       method: str, *args) -> None:
        """Overwrites any pending task with the same name."""
        self.cancel_named(name)
        agenda = self.state.get(PALLET, "agenda", at_block, default=())
        self.state.put(PALLET, "agenda", at_block,
                       agenda + ((name, pallet, method, args),))
        self.state.put(PALLET, "lookup", name, at_block)

    def cancel_named(self, name: str) -> None:
        at = self.state.get(PALLET, "lookup", name)
        if at is None:
            return
        agenda = self.state.get(PALLET, "agenda", at, default=())
        agenda = tuple(t for t in agenda if t[0] != name)
        if agenda:
            self.state.put(PALLET, "agenda", at, agenda)
        else:
            self.state.delete(PALLET, "agenda", at)
        self.state.delete(PALLET, "lookup", name)

    def take_due(self) -> list[tuple[str, str, str, tuple]]:
        """Pop this block's agenda (runtime dispatches each entry)."""
        now = self.state.block
        agenda = self.state.get(PALLET, "agenda", now, default=())
        if agenda:
            self.state.delete(PALLET, "agenda", now)
            for name, *_ in agenda:
                self.state.delete(PALLET, "lookup", name)
        return list(agenda)
