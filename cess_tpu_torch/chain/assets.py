"""Fungible asset classes + fee payment in assets (reference:
pallet_assets + pallet_asset_tx_payment,
runtime/src/lib.rs:1490-1502 ids 12-13).

Capability parity, redesigned native:
- asset classes with the reference's four-role team (owner / issuer /
  admin / freezer), min_balance dust rule (a transfer may not strand a
  destination below it; a debit that would leave dust burns the
  remainder), per-account and whole-asset freezing, and metadata.
- the AssetTxPayment role — "pay transaction fees in an asset" — is an
  on-chain ACCOUNT PREFERENCE (``set_fee_asset``) instead of the
  reference's per-extrinsic SignedExtension field: the capability is
  identical (fees charged in the asset at a governance-set conversion
  rate, split 80/20 treasury/author like native fees), but the wire
  format of signed extrinsics stays unchanged. The preference only
  takes effect for assets with a root-set fee rate, and fee charging
  falls back to native tokens when the asset can't cover the fee —
  a stale preference can never brick an account.
"""
from __future__ import annotations

import dataclasses

from .. import codec
from .. import constants
from .state import DispatchError, State

PALLET = "assets"
MAX_METADATA = 64
# pallet_assets reserves AssetDeposit on create so asset-id squatting
# and state growth aren't free; refunded by destroy
ASSET_DEPOSIT = 10 * constants.DOLLARS


@codec.register
@dataclasses.dataclass(frozen=True)
class AssetDetails:
    owner: str
    issuer: str
    admin: str
    freezer: str
    supply: int
    min_balance: int
    frozen: bool = False


@codec.register
@dataclasses.dataclass(frozen=True)
class AssetMetadata:
    name: str
    symbol: str
    decimals: int


class Assets:
    def __init__(self, state: State, balances):
        self.state = state
        self.balances = balances

    # -- queries -------------------------------------------------------------
    def asset(self, asset_id: int) -> AssetDetails | None:
        return self.state.get(PALLET, "asset", asset_id)

    def balance(self, asset_id: int, who: str) -> int:
        return self.state.get(PALLET, "account", asset_id, who, default=0)

    def metadata(self, asset_id: int) -> AssetMetadata | None:
        return self.state.get(PALLET, "metadata", asset_id)

    def _require(self, asset_id: int) -> AssetDetails:
        a = self.asset(asset_id)
        if a is None:
            raise DispatchError("assets.Unknown", str(asset_id))
        return a

    @staticmethod
    def _check_amount(v) -> int:
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            raise DispatchError("assets.BadAmount")
        return v

    # -- lifecycle -----------------------------------------------------------
    def create(self, who: str, asset_id: int, min_balance: int = 1) -> None:
        """Permissionless create: caller becomes the whole team and
        reserves ASSET_DEPOSIT, refunded on destroy (pallet_assets
        create + AssetDeposit)."""
        if not isinstance(asset_id, int) or isinstance(asset_id, bool) \
                or asset_id < 0:
            raise DispatchError("assets.BadAssetId")
        if self.asset(asset_id) is not None:
            raise DispatchError("assets.InUse", str(asset_id))
        if not isinstance(min_balance, int) or isinstance(min_balance, bool) \
                or min_balance < 1:
            raise DispatchError("assets.BadMinBalance")
        self.balances.reserve(who, ASSET_DEPOSIT)
        self.state.put(PALLET, "deposit", asset_id, (who, ASSET_DEPOSIT))
        self.state.put(PALLET, "asset", asset_id, AssetDetails(
            owner=who, issuer=who, admin=who, freezer=who, supply=0,
            min_balance=min_balance))
        self.state.deposit_event(PALLET, "Created", asset_id=asset_id,
                                 owner=who)

    def destroy(self, who: str, asset_id: int) -> None:
        """Owner removes a fully-burned asset class; the creation
        deposit returns to whoever reserved it (pallet_assets destroy,
        collapsed to the supply == 0 case — accounts must be burned
        first, so no unbounded teardown inside one dispatch)."""
        a = self._require(asset_id)
        if who != a.owner:
            raise DispatchError("assets.NoPermission")
        if a.supply != 0:
            raise DispatchError("assets.InUse", "supply not zero")
        for suffix, _ in list(self.state.iter_prefix(PALLET, "account",
                                                     asset_id)):
            self.state.delete(PALLET, "account", asset_id, *suffix)
        for suffix, _ in list(self.state.iter_prefix(PALLET, "frozen",
                                                     asset_id)):
            self.state.delete(PALLET, "frozen", asset_id, *suffix)
        dep = self.state.get(PALLET, "deposit", asset_id)
        if dep is not None:
            self.balances.unreserve(dep[0], dep[1])
            self.state.delete(PALLET, "deposit", asset_id)
        self.state.delete(PALLET, "asset", asset_id)
        self.state.delete(PALLET, "metadata", asset_id)
        self.state.delete(PALLET, "fee_rate", asset_id)
        self.state.deposit_event(PALLET, "Destroyed", asset_id=asset_id)

    def set_team(self, who: str, asset_id: int, issuer: str, admin: str,
                 freezer: str) -> None:
        a = self._require(asset_id)
        if who != a.owner:
            raise DispatchError("assets.NoPermission")
        self.state.put(PALLET, "asset", asset_id, dataclasses.replace(
            a, issuer=issuer, admin=admin, freezer=freezer))

    def transfer_ownership(self, who: str, asset_id: int,
                           new_owner: str) -> None:
        a = self._require(asset_id)
        if who != a.owner:
            raise DispatchError("assets.NoPermission")
        self.state.put(PALLET, "asset", asset_id,
                       dataclasses.replace(a, owner=new_owner))

    def set_metadata(self, who: str, asset_id: int, name: str,
                     symbol: str, decimals: int) -> None:
        a = self._require(asset_id)
        if who != a.owner:
            raise DispatchError("assets.NoPermission")
        if not (isinstance(name, str) and isinstance(symbol, str)
                and len(name) <= MAX_METADATA
                and len(symbol) <= MAX_METADATA
                and isinstance(decimals, int)
                and 0 <= decimals <= 38):
            raise DispatchError("assets.BadMetadata")
        self.state.put(PALLET, "metadata", asset_id, AssetMetadata(
            name=name, symbol=symbol, decimals=decimals))

    # -- supply --------------------------------------------------------------
    def mint(self, who: str, asset_id: int, beneficiary: str,
             amount: int) -> None:
        a = self._require(asset_id)
        amount = self._check_amount(amount)
        if who != a.issuer:
            raise DispatchError("assets.NoPermission")
        have = self.balance(asset_id, beneficiary)
        if have + amount < a.min_balance:
            raise DispatchError("assets.BelowMinimum")
        self.state.put(PALLET, "account", asset_id, beneficiary,
                       have + amount)
        self.state.put(PALLET, "asset", asset_id,
                       dataclasses.replace(a, supply=a.supply + amount))
        self.state.deposit_event(PALLET, "Issued", asset_id=asset_id,
                                 to=beneficiary, amount=amount)

    def burn(self, who: str, asset_id: int, target: str,
             amount: int) -> None:
        a = self._require(asset_id)
        amount = self._check_amount(amount)
        if who != a.admin:
            raise DispatchError("assets.NoPermission")
        burned = self._debit(asset_id, a, target, amount)
        self.state.deposit_event(PALLET, "Burned", asset_id=asset_id,
                                 who=target, amount=burned)

    def _withdraw(self, asset_id: int, a: AssetDetails, who: str,
                  amount: int) -> int:
        """THE one implementation of the min_balance debit rule: remove
        ``amount`` from ``who``; a remainder below min_balance is dust.
        Returns the dust (which has left the account but NOT yet been
        burned from supply — the caller decides where amount goes)."""
        have = self.balance(asset_id, who)
        if have < amount:
            raise DispatchError("assets.BalanceLow")
        left = have - amount
        dust = 0
        if 0 < left < a.min_balance:
            dust, left = left, 0
        if left:
            self.state.put(PALLET, "account", asset_id, who, left)
        else:
            self.state.delete(PALLET, "account", asset_id, who)
        return dust

    def _burn_supply(self, asset_id: int, amount: int) -> None:
        if amount:
            a = self._require(asset_id)
            self.state.put(PALLET, "asset", asset_id,
                           dataclasses.replace(a, supply=a.supply - amount))

    def _debit(self, asset_id: int, a: AssetDetails, who: str,
               amount: int) -> int:
        """Burn ``amount`` (plus any dust) out of circulation; returns
        the total removed."""
        dust = self._withdraw(asset_id, a, who, amount)
        self._burn_supply(asset_id, amount + dust)
        return amount + dust

    # -- transfers -----------------------------------------------------------
    def transfer(self, who: str, asset_id: int, dest: str,
                 amount: int) -> None:
        a = self._require(asset_id)
        amount = self._check_amount(amount)
        if a.frozen or self.state.get(PALLET, "frozen", asset_id, who,
                                      default=False):
            raise DispatchError("assets.Frozen")
        if self.balance(asset_id, dest) + amount < a.min_balance:
            raise DispatchError("assets.BelowMinimum")
        if who == dest:
            # identity after validation: a round-trip through _withdraw
            # would burn a sub-min_balance remainder as dust on an
            # intent-neutral operation
            if self.balance(asset_id, who) < amount:
                raise DispatchError("assets.BalanceLow")
            self.state.deposit_event(PALLET, "Transferred",
                                     asset_id=asset_id, src=who, dst=dest,
                                     amount=amount)
            return
        dust = self._withdraw(asset_id, a, who, amount)
        # credit AFTER the debit, re-reading the destination: a
        # self-transfer is then the identity it should be (stale
        # pre-debit reads let who == dest mint, review-reproduced)
        self.state.put(PALLET, "account", asset_id, dest,
                       self.balance(asset_id, dest) + amount)
        self._burn_supply(asset_id, dust)
        self.state.deposit_event(PALLET, "Transferred", asset_id=asset_id,
                                 src=who, dst=dest, amount=amount)

    # -- freezing ------------------------------------------------------------
    def freeze(self, who: str, asset_id: int, target: str) -> None:
        a = self._require(asset_id)
        if who != a.freezer:
            raise DispatchError("assets.NoPermission")
        self.state.put(PALLET, "frozen", asset_id, target, True)

    def thaw(self, who: str, asset_id: int, target: str) -> None:
        a = self._require(asset_id)
        if who != a.admin:
            raise DispatchError("assets.NoPermission")
        self.state.delete(PALLET, "frozen", asset_id, target)

    def freeze_asset(self, who: str, asset_id: int) -> None:
        a = self._require(asset_id)
        if who != a.freezer:
            raise DispatchError("assets.NoPermission")
        self.state.put(PALLET, "asset", asset_id,
                       dataclasses.replace(a, frozen=True))

    def thaw_asset(self, who: str, asset_id: int) -> None:
        a = self._require(asset_id)
        if who != a.admin:
            raise DispatchError("assets.NoPermission")
        self.state.put(PALLET, "asset", asset_id,
                       dataclasses.replace(a, frozen=False))

    # -- fee payment in assets (pallet_asset_tx_payment role) ----------------
    def set_fee_rate(self, asset_id: int, num: int, den: int) -> None:
        """Root: asset units charged per native fee unit = num/den
        (the reference's asset-conversion config)."""
        self._require(asset_id)
        if not (isinstance(num, int) and isinstance(den, int)
                and num > 0 and den > 0):
            raise DispatchError("assets.BadRate")
        self.state.put(PALLET, "fee_rate", asset_id, (num, den))

    def fee_rate(self, asset_id: int):
        return self.state.get(PALLET, "fee_rate", asset_id)

    def set_fee_asset(self, who: str, asset_id) -> None:
        """Opt in (or out, with None) to paying fees in an asset."""
        if asset_id is None:
            self.state.delete(PALLET, "fee_asset", who)
            return
        if self.fee_rate(asset_id) is None:
            raise DispatchError("assets.NoFeeRate", str(asset_id))
        self.state.put(PALLET, "fee_asset", who, asset_id)

    def fee_asset_of(self, who: str):
        return self.state.get(PALLET, "fee_asset", who)

    def fee_in_asset(self, who: str, native_fee: int):
        """(asset_id, asset_fee) if the account's preference can cover
        this fee, else None (caller falls back to native charging)."""
        asset_id = self.fee_asset_of(who)
        if asset_id is None or native_fee <= 0:
            return None
        a = self.asset(asset_id)
        rate = self.fee_rate(asset_id)
        if a is None or rate is None or a.frozen:
            return None
        fee = -(-native_fee * rate[0] // rate[1])    # ceil
        have = self.balance(asset_id, who)
        if have < fee or self.state.get(PALLET, "frozen", asset_id, who,
                                        default=False):
            return None
        # the debit must not strand dust below min_balance unexpectedly
        return asset_id, fee

    def charge_fee(self, who: str, asset_id: int, fee: int,
                   treasury: str, author: str) -> None:
        """Move the asset fee 80/20 treasury/author (the native split,
        runtime/src/lib.rs:190-204, applied to the chosen asset). Fee
        sinks are system accounts, exempt from the min_balance dust
        rule; a payer remainder below min_balance burns as dust."""
        a = self._require(asset_id)
        dust = self._withdraw(asset_id, a, who, fee)
        to_treasury = fee * 8 // 10
        for dest, amt in ((treasury, to_treasury),
                          (author or treasury, fee - to_treasury)):
            if amt:
                self.state.put(PALLET, "account", asset_id, dest,
                               self.balance(asset_id, dest) + amt)
        self._burn_supply(asset_id, dust)
        self.state.deposit_event(PALLET, "FeePaid", who=who,
                                 asset_id=asset_id, amount=fee)