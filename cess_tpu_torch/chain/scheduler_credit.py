"""Scheduler (TEE) credit scoring feeding validator election.

Reference: c-pallets/scheduler-credit — per-period accumulation of
bytes processed + punishment counts; score = share-of-work x 1000
- (10 x punish)^2; 5-period weighted history 50/20/15/10/5%.
Mirrors src/lib.rs: figure_credit_value :61-75, period rollover
:113-125, figure_credit_scores :187-227, ValidatorCredits :242-251,
weights :36-42.
"""
from __future__ import annotations

from .. import constants
from .state import State

PALLET = "scheduler_credit"

PERIOD_BLOCKS = constants.EPOCH_DURATION_BLOCKS * constants.SESSIONS_PER_ERA


class SchedulerCredit:
    def __init__(self, state: State, period_blocks: int = PERIOD_BLOCKS):
        self.state = state
        self.period_blocks = period_blocks

    # -- SchedulerCreditCounter trait ---------------------------------------
    def record_proceed_block_size(self, scheduler: str, size: int) -> None:
        cur = self.state.get(PALLET, "current", scheduler,
                             default=(0, 0))  # (bytes, punish)
        self.state.put(PALLET, "current", scheduler, (cur[0] + size, cur[1]))

    def record_punishment(self, scheduler: str) -> None:
        cur = self.state.get(PALLET, "current", scheduler, default=(0, 0))
        self.state.put(PALLET, "current", scheduler, (cur[0], cur[1] + 1))

    # -- scoring -------------------------------------------------------------
    @staticmethod
    def figure_credit_value(total_size: int, entry: tuple[int, int]) -> int:
        """share-of-work x 1000 - (10*punish)^2, floored at 0
        (lib.rs:61-75)."""
        size, punish = entry
        score = 0
        if total_size > 0:
            score = size * constants.CREDIT_SCORE_SCALE // total_size
        penalty = (10 * punish) ** 2
        return max(0, score - penalty)

    def _rollover(self) -> None:
        """Close the current period into each scheduler's history
        (most-recent first, 5 kept)."""
        entries = list(self.state.iter_prefix(PALLET, "current"))
        total = sum(e[0] for _, e in entries)
        for (who,), entry in entries:
            value = self.figure_credit_value(total, entry)
            hist = self.state.get(PALLET, "history", who, default=())
            hist = (value,) + hist[:len(constants.CREDIT_HISTORY_WEIGHTS) - 1]
            self.state.put(PALLET, "history", who, hist)
            self.state.delete(PALLET, "current", who)
        self.state.deposit_event(PALLET, "PeriodRollover",
                                 schedulers=len(entries), total=total)

    def credits(self) -> dict[str, int]:
        """Weighted 5-period credit per scheduler (ValidatorCredits
        impl, figure_credit_scores :187-227)."""
        out = {}
        for (who,), hist in self.state.iter_prefix(PALLET, "history"):
            score = 0
            for value, weight in zip(hist, constants.CREDIT_HISTORY_WEIGHTS):
                score += value * weight // 100
            out[who] = score
        return out

    # -- hook -----------------------------------------------------------------
    def on_initialize(self) -> None:
        if self.state.block > 0 and self.state.block % self.period_blocks == 0:
            self._rollover()
