"""EVM capability boundary: accounts, contracts, real execution.

The reference embeds the Frontier EVM stack + Wasm contracts
(runtime/src/lib.rs:1310-1380,1524-1528: Contracts,
Ethereum, EVM, DynamicFee, BaseFee; node-side Frontier DB + RPC
workers, node/src/service.rs:56-81,392-429). This module is the same
boundary with a framework-native engine behind it
(chain/evm_interp.py): deploy runs INIT code and stores the
returned runtime code; call/query execute the core opcode set with gas
metering; contract storage lives in the chain KV; LOG0-4 entries are
archived per block for eth_getLogs. Inter-contract CALL / STATICCALL /
DELEGATECALL and CREATE/CREATE2 execute through the recursive hosts
below (depth-capped, commit-on-success overlays; query() routes ALL
writes — inner frames included — into throwaway session overlays).

Value model (pallet-evm's EVMCurrencyAdapter role): the EVM domain
holds its own balance ledger keyed by 20-byte address, backed 1:1 by
a pot account (EVM_POT) on the native side — deposit moves native
tokens into the pot and credits eth_address(who); withdraw debits the
caller's EVM address and pays out of the pot, so ANY address holding
EVM balance (contracts included, once swept to a user) is always
covered by pot funds. Value-carrying calls and CREATE move EVM-domain
balance inside the frame overlays, so a reverted frame's transfers
unwind with its storage writes.

Precompiles 0x1-0x4 (ecrecover via crypto/secp256k1.py, sha256,
ripemd160, identity) are serviced by the call host at mainnet-shaped
gas prices.

Gas bounds block work: every call carries a gas limit capped at
GAS_CAP, so a looping contract burns its gas and reverts — block
production can never stall (tested in tests/test_evm.py).
"""
from __future__ import annotations

import hashlib

from . import evm_interp
from ..crypto import secp256k1
from .evm_interp import EvmError, EvmRevert
from .overlay import ChainedOverlay
from .state import DispatchError, State

PALLET = "evm"
GAS_CAP = 5_000_000       # per-call ceiling (block-stall bound)
DEFAULT_GAS = 1_000_000
MAX_CODE = 64 * 1024

# native account backing the EVM domain ledger; the ':' makes it
# unsignable (runtime._check_shape rejects colon signers), so nobody
# can transact AS the pot
EVM_POT = "evm:pot"

# base-fee market (the pallet_base_fee / pallet_dynamic_fee role,
# ref runtime/src/lib.rs:1527-1528): EIP-1559-style — the per-block
# base fee moves up to 1/8 toward demand, measured against a gas
# target of half the block's practical capacity. The fee is what Eth
# tooling reads via eth_gasPrice / eth_feeHistory; execution costs
# stay weight-fee denominated (the boundary's documented scope).
INITIAL_BASE_FEE = 10 ** 9          # 1 gwei
MIN_BASE_FEE = 7
GAS_TARGET_PER_BLOCK = GAS_CAP // 2
FEE_HISTORY_MAX = 1024


def eth_address(who: str) -> bytes:
    """Deterministic 20-byte EVM address for a native account."""
    return hashlib.sha256(b"evm-addr:" + who.encode()).digest()[:20]


def create_address(creator: bytes, nonce: int) -> bytes:
    """CREATE-style address: hash of creator address + account nonce
    (sha256 in place of keccak/RLP, per the interpreter's documented
    hash deviation)."""
    return hashlib.sha256(b"evm-create:" + creator
                          + nonce.to_bytes(8, "little")).digest()[:20]


def create2_address(creator: bytes, salt: bytes, init: bytes) -> bytes:
    """EIP-1014-shaped: predictable from (creator, salt, init) alone,
    so factories and counterfactual deployments work."""
    return hashlib.sha256(b"evm-create2:" + creator + salt
                          + hashlib.sha256(init).digest()).digest()[:20]


def next_base_fee(base: int, gas_used: int,
                  target: int = GAS_TARGET_PER_BLOCK) -> int:
    """EIP-1559 update rule: up to +-1/8 per block toward demand."""
    delta = base * (gas_used - target) // target // 8
    return max(MIN_BASE_FEE, base + delta)


# -- precompiles 0x1-0x4 (mainnet gas shape) --------------------------------

def _pc_ecrecover(data: bytes):
    data = data.ljust(128, b"\0")
    h, v, r, s = (data[0:32], int.from_bytes(data[32:64], "big"),
                  int.from_bytes(data[64:96], "big"),
                  int.from_bytes(data[96:128], "big"))
    addr = secp256k1.recover_address(h, v, r, s)
    # invalid signature: SUCCESS with empty output (mainnet semantics)
    return addr.rjust(32, b"\0") if addr is not None else b""


# resolved ONCE at import: hashlib's ripemd160 exists only when the
# OpenSSL build ships the legacy provider; a per-call failure swallowed
# by the call host would be a consensus split between nodes that differ
# in that build detail. Both paths produce identical digests (standard
# algorithm; cross-checked in tests/test_evm.py).
try:
    hashlib.new("ripemd160", b"")
    def _ripemd160(data: bytes) -> bytes:
        return hashlib.new("ripemd160", data).digest()
except ValueError:
    from ..crypto.ripemd160 import digest as _ripemd160


def _pc_ripemd160(data: bytes) -> bytes:
    return _ripemd160(data).rjust(32, b"\0")


PRECOMPILES = {
    1: (_pc_ecrecover, lambda d: 3000),
    2: (lambda d: hashlib.sha256(d).digest(),
        lambda d: 60 + 12 * ((len(d) + 31) // 32)),
    3: (_pc_ripemd160, lambda d: 600 + 120 * ((len(d) + 31) // 32)),
    4: (lambda d: d, lambda d: 15 + 3 * ((len(d) + 31) // 32)),
}


class Evm:
    def __init__(self, state: State, balances):
        self.state = state
        self.balances = balances

    # -- accounts (pallet-evm deposit/withdraw analog) -----------------------
    def deposit(self, who: str, amount: int) -> None:
        """Move native balance into the EVM domain: tokens go to the
        pot, the credit lands on eth_address(who)."""
        if not isinstance(amount, int) or amount <= 0:
            raise DispatchError("evm.InvalidAmount")
        self.balances.transfer(who, EVM_POT, amount)
        addr = eth_address(who)
        self._credit(addr, amount)
        self.state.deposit_event(PALLET, "Deposited", who=who,
                                 amount=amount)

    def withdraw(self, who: str, amount: int) -> None:
        addr = eth_address(who)
        bal = self.balance_of(addr)
        if not isinstance(amount, int) or amount <= 0 or amount > bal:
            raise DispatchError("evm.InvalidAmount")
        self.state.put(PALLET, "balance", addr, bal - amount)
        self.balances.transfer(EVM_POT, who, amount)
        self.state.deposit_event(PALLET, "Withdrawn", who=who,
                                 amount=amount)

    def balance_of(self, address: bytes) -> int:
        return self.state.get(PALLET, "balance", address, default=0)

    def balance(self, who) -> int:
        """EVM-domain balance; accepts a native account name or a
        20-byte address (eth_getBalance serves both)."""
        if isinstance(who, str):
            who = eth_address(who)
        return self.balance_of(who)

    def _credit(self, address: bytes, amount: int) -> None:
        self.state.put(PALLET, "balance", address,
                       self.balance_of(address) + amount)

    # -- storage bridge -------------------------------------------------------
    def _sload(self, addr: bytes):
        return lambda k: self.state.get(PALLET, "storage", addr, k,
                                        default=0)

    def _sstore(self, addr: bytes):
        def store(k: int, v: int) -> None:
            if v == 0:
                self.state.delete(PALLET, "storage", addr, k)
            else:
                self.state.put(PALLET, "storage", addr, k, v)
        return store

    def storage_at(self, address: bytes, key: int) -> int:
        return self.state.get(PALLET, "storage", address, key, default=0)

    # -- world overlay ---------------------------------------------------------
    # Frame-chained view of ALL EVM-domain state: storage slots
    # ("s", addr, slot), balances ("b", addr), code ("c", addr) and
    # creator nonces ("n", addr) — one overlay per call frame, so a
    # reverted frame's value transfers and CREATEs unwind exactly like
    # its storage writes (see chain/overlay.py).
    def _root_get(self, key):
        tag = key[0]
        if tag == "s":
            return self.state.get(PALLET, "storage", key[1], key[2],
                                  default=0)
        if tag == "b":
            return self.balance_of(key[1])
        if tag == "c":
            return self.state.get(PALLET, "code", key[1], default=b"")
        return self.state.get(PALLET, "nonce", key[1], default=0)

    def _root_put(self, key, value) -> None:
        tag = key[0]
        if tag == "s":
            self._sstore(key[1])(key[2], value)
        elif tag == "b":
            self.state.put(PALLET, "balance", key[1], value)
        elif tag == "c":
            self.state.put(PALLET, "code", key[1], value)
        else:
            self.state.put(PALLET, "nonce", key[1], value)

    MAX_CALL_DEPTH = 8

    class _World(ChainedOverlay):
        def __init__(self, evm: "Evm", parent=None):
            super().__init__(root_get=evm._root_get,
                             root_put=evm._root_put, parent=parent)
            self.evm = evm

        def hooks(self, a: bytes):
            return (lambda k: self.get(("s", a, k)),
                    lambda k, v: self.put(("s", a, k), v))

        def balance(self, a: bytes) -> int:
            return self.get(("b", a))

        def transfer(self, frm: bytes, to: bytes, amount: int) -> bool:
            # the < 0 guard is load-bearing: a negative amount passes
            # 'have < amount' and MINTS balance (review-reproduced
            # pot-drain via negative-value deploy)
            if not isinstance(amount, int) or amount < 0:
                return False
            if amount == 0:
                return True
            have = self.balance(frm)
            if have < amount:
                return False
            self.put(("b", frm), have - amount)
            self.put(("b", to), self.balance(to) + amount)
            return True

        def code(self, a: bytes) -> bytes:
            return self.get(("c", a))

        def set_code(self, a: bytes, code: bytes) -> None:
            self.put(("c", a), code)

        def next_nonce(self, a: bytes) -> int:
            n = self.get(("n", a))
            self.put(("n", a), n + 1)
            return n

    def code_at(self, address: bytes) -> bytes | None:
        """None = no code entry at all; b"" = a contract whose init
        returned empty runtime code (a real, distinct account state —
        mainnet treats it as a plain account that accepts calls and
        value, so conflating the two made its balance unreachable)."""
        return self.state.get(PALLET, "code", address)

    def _check_gas(self, gas_limit) -> int:
        if not isinstance(gas_limit, int) or gas_limit <= 0:
            raise DispatchError("evm.InvalidGas")
        return min(gas_limit, GAS_CAP)

    @staticmethod
    def _fail(name: str, detail: str, gas_used: int) -> DispatchError:
        """Failed executions consumed metered work the fee side charges
        for; the error carries the gas so the runtime can count it
        toward the base-fee market AFTER the dispatch rolls back (a
        _note_gas here would be undone with the transaction)."""
        err = DispatchError(name, detail)
        err.evm_gas_used = gas_used
        return err

    def _env(self) -> dict:
        return {"number": self.state.block,
                "timestamp": self.state.get(
                    "system", "now_ms", default=0) // 1000,
                "chainid": self.state.get("system", "chain_id", default=0),
                "basefee": self.base_fee(),
                "gasprice": self.base_fee(),
                "coinbase": eth_address(self.state.get(
                    "system", "author", default="") or "")}

    # -- recursive hosts ------------------------------------------------------
    def _exec_args(self, world: "Evm._World", addr: bytes,
                   caller: bytes, origin: bytes, static: bool,
                   depth: int) -> dict:
        """The per-frame hook bundle every execute() call shares."""
        sload, sstore = world.hooks(addr)
        return dict(
            caller=caller, address=addr, origin=origin,
            sload=sload, sstore=sstore, static=static,
            balance=world.balance, extcode=world.code, env=self._env(),
            call_host=self._host(addr, caller, origin, static, depth,
                                 world),
            create_host=self._create_host(addr, origin, static, depth,
                                          world))

    def _host(self, frame_addr: bytes, frame_caller: bytes,
              origin: bytes, static: bool, depth: int,
              world: "Evm._World"):
        """call_host closure for one frame (see _World for the commit
        discipline): precompile dispatch, plain value transfers to
        codeless accounts, and recursive execution with value."""
        def call_host(kind, to, data, fwd_gas, value):
            if not isinstance(value, int) or value < 0:
                return 0, b"", 0, []
            pc_id = int.from_bytes(to, "big")
            if pc_id in PRECOMPILES:
                fn, cost = PRECOMPILES[pc_id]
                c = cost(data)
                if c > fwd_gas:
                    return 0, b"", fwd_gas, []
                if value and kind == "call":
                    # mainnet moves CALL value to the precompile
                    # address like any other account; DELEGATECALL's
                    # apparent value rides along without a transfer
                    # (review-reproduced drain otherwise)
                    child = Evm._World(self, parent=world)
                    if not child.transfer(frame_addr, to, value):
                        return 0, b"", 0, []
                    child.commit()
                try:
                    return 1, fn(data), c, []
                except Exception:
                    return 0, b"", fwd_gas, []
            if depth >= self.MAX_CALL_DEPTH:
                return 0, b"", 0, []
            child = Evm._World(self, parent=world)
            if kind == "call" and value:
                if not child.transfer(frame_addr, to, value):
                    return 0, b"", 0, []   # insufficient balance
            code = child.code(to)
            if not code:
                # codeless account: a plain value transfer, success
                child.commit()
                return 1, b"", 0, []
            if kind == "delegate":
                # callee code, THIS frame's storage/identity/caller
                inner_addr, inner_caller = frame_addr, frame_caller
            else:
                inner_addr, inner_caller = to, frame_addr
            inner_static = static or kind == "static"
            try:
                res = evm_interp.execute(
                    code, calldata=data, gas_limit=fwd_gas,
                    value=value,
                    **self._exec_args(child, inner_addr, inner_caller,
                                      origin, inner_static, depth + 1))
            except EvmRevert as e:
                return 0, e.data, e.gas_used, []
            except EvmError:
                return 0, b"", fwd_gas, []
            child.commit()              # into the PARENT frame's world
            return 1, res.output, res.gas_used, res.logs
        return call_host

    def _create_host(self, frame_addr: bytes, origin: bytes,
                     static: bool, depth: int, world: "Evm._World"):
        """CREATE/CREATE2 from bytecode: run init in a child world at
        the derived address; commit code+writes only on success."""
        def create_host(init, value, salt, fwd_gas):
            if depth >= self.MAX_CALL_DEPTH or static \
                    or len(init) > MAX_CODE:
                return 0, b"", 0, []
            if value and world.balance(frame_addr) < value:
                # mainnet: insufficient-balance CREATE fails BEFORE the
                # nonce bump (geth create() order)
                return 0, b"", 0, []
            # the nonce bump lands in the PARENT world, so it persists
            # even when init reverts and the child overlay is discarded
            # (mainnet semantics): a retried create gets a FRESH
            # address instead of deterministically reusing the old one
            nonce = world.next_nonce(frame_addr)
            child = Evm._World(self, parent=world)
            if salt is None:
                new = create_address(frame_addr, nonce)
            else:
                new = create2_address(frame_addr, salt, init)
            if child.code(new):
                return 0, b"", fwd_gas, []   # address collision
            if value and not child.transfer(frame_addr, new, value):
                return 0, b"", 0, []
            try:
                res = evm_interp.execute(
                    init, calldata=b"", gas_limit=fwd_gas, value=value,
                    **self._exec_args(child, new, frame_addr, origin,
                                      False, depth + 1))
            except EvmRevert as e:
                return 0, e.data, e.gas_used, []
            except EvmError:
                return 0, b"", fwd_gas, []
            if len(res.output) > MAX_CODE:
                return 0, b"", fwd_gas, []
            child.set_code(new, res.output)
            child.commit()
            return (int.from_bytes(new, "big"), b"", res.gas_used,
                    res.logs)
        return create_host

    # -- contracts -----------------------------------------------------------
    def deploy(self, who: str, code: bytes,
               gas_limit: int = DEFAULT_GAS, value: int = 0) -> bytes:
        """Run INIT ``code``; its RETURN data becomes the contract's
        runtime code at a CREATE-style address (hash of deployer
        address + nonce). ``value`` endows the new contract from the
        deployer's EVM balance. Reverts/exceptional halts fail the
        dispatch."""
        if not isinstance(code, bytes) or not code or len(code) > MAX_CODE:
            raise DispatchError("evm.InvalidCode")
        if not isinstance(value, int) or value < 0:
            raise DispatchError("evm.InvalidAmount")
        gas_limit = self._check_gas(gas_limit)
        caller = eth_address(who)
        nonce = self.state.get(PALLET, "nonce", caller, default=0)
        self.state.put(PALLET, "nonce", caller, nonce + 1)
        addr = create_address(caller, nonce)
        world = Evm._World(self)
        if value and not world.transfer(caller, addr, value):
            raise DispatchError("evm.InsufficientBalance")
        try:
            res = evm_interp.execute(
                code, calldata=b"", gas_limit=gas_limit, value=value,
                **self._exec_args(world, addr, caller, caller, False, 0))
        except EvmRevert as e:
            raise self._fail("evm.Reverted", e.data.hex(), e.gas_used) from e
        except EvmError as e:
            raise self._fail("evm.ExecutionFailed", str(e), gas_limit) from e
        runtime = res.output
        if len(runtime) > MAX_CODE:
            raise DispatchError("evm.InvalidCode", "runtime too large")
        world.set_code(addr, runtime)
        world.commit()
        self._note_gas(res.gas_used)   # deploys count toward the market
        self._archive_logs(res.logs)
        self.state.put(PALLET, "last_exec", (res.gas_used, addr))
        self.state.deposit_event(PALLET, "Deployed", who=who,
                                 address=addr, code_len=len(runtime),
                                 gas_used=res.gas_used)
        return addr

    def call(self, who: str, address: bytes, calldata: bytes,
             gas_limit: int = DEFAULT_GAS, value: int = 0) -> bytes:
        """Execute a contract call; storage writes + logs + value
        moves commit with the surrounding dispatch transaction."""
        code = self.code_at(address)
        if code is None:
            raise DispatchError("evm.NoContract")
        if not isinstance(calldata, bytes) \
                or not isinstance(value, int) or value < 0:
            raise DispatchError("evm.InvalidCall")
        gas_limit = self._check_gas(gas_limit)
        caller = eth_address(who)
        world = Evm._World(self)           # root: commits to chain
        if value and not world.transfer(caller, address, value):
            raise DispatchError("evm.InsufficientBalance")
        if not code:
            # empty runtime code (init returned b""): a plain account
            # per mainnet — the call is a pure value transfer, so
            # balance parked there stays reachable (the inner call_host
            # already behaved this way; the top-level entry now agrees)
            world.commit()
            self.state.put(PALLET, "last_exec", (0, None))
            self.state.deposit_event(PALLET, "Called", who=who,
                                     address=address, out_len=0,
                                     gas_used=0)
            return b""
        try:
            res = evm_interp.execute(
                code, calldata=calldata, gas_limit=gas_limit,
                value=value,
                **self._exec_args(world, address, caller, caller,
                                  False, 0))
        except EvmRevert as e:
            raise self._fail("evm.Reverted", e.data.hex(), e.gas_used) from e
        except EvmError as e:
            raise self._fail("evm.ExecutionFailed", str(e), gas_limit) from e
        world.commit()
        self._note_gas(res.gas_used)
        self._archive_logs(res.logs)
        self.state.put(PALLET, "last_exec", (res.gas_used, None))
        self.state.deposit_event(PALLET, "Called", who=who,
                                 address=address, out_len=len(res.output),
                                 gas_used=res.gas_used)
        return res.output

    def query(self, address: bytes, calldata: bytes,
              caller: str = "", gas_limit: int = DEFAULT_GAS,
              value: int = 0) -> bytes:
        """Read-only call (eth_call analog): same engine, storage reads
        come from chain state, writes go to a throwaway overlay, no
        events or logs are archived."""
        return self._simulate(address, calldata, caller, gas_limit,
                              value).output

    def estimate(self, address: bytes | None, calldata: bytes,
                 caller: str = "", value: int = 0) -> int:
        """eth_estimateGas: simulate at the cap, report gas consumed
        (the schedule is deterministic, so the measure is exact; a
        failed simulation raises like eth_estimateGas errors do)."""
        if address is None:      # deploy estimate
            world = Evm._World(self)
            caller_w = eth_address(caller)
            addr = create_address(caller_w, 2 ** 62)  # scratch address
            # mirror deploy(): endow BEFORE init runs, so SELFBALANCE
            # and underfunding behave exactly as they will on-chain
            if value and not world.transfer(caller_w, addr, value):
                raise DispatchError("evm.InsufficientBalance")
            try:
                res = evm_interp.execute(
                    calldata, calldata=b"", gas_limit=GAS_CAP,
                    value=value,
                    **self._exec_args(world, addr, caller_w, caller_w,
                                      False, 0))
            except EvmRevert as e:
                raise DispatchError("evm.Reverted", e.data.hex()) from e
            except EvmError as e:
                raise DispatchError("evm.ExecutionFailed", str(e)) from e
            return res.gas_used
        return self._simulate(address, calldata, caller, GAS_CAP,
                              value).gas_used

    def _simulate(self, address: bytes, calldata: bytes, caller: str,
                  gas_limit: int, value: int):
        code = self.code_at(address)
        if code is None:
            raise DispatchError("evm.NoContract")
        if not isinstance(calldata, bytes):
            raise DispatchError("evm.InvalidCall")
        gas_limit = self._check_gas(gas_limit)
        # a root world that is NEVER committed: every write in this
        # simulation — inner frames included — is thrown away
        world = Evm._World(self)
        caller_w = eth_address(caller)
        if value and not world.transfer(caller_w, address, value):
            raise DispatchError("evm.InsufficientBalance")
        if not code:
            # empty-code account: eth_call/estimate see a successful
            # no-op transfer (mirrors call() above)
            return evm_interp.ExecResult(output=b"", gas_used=0, logs=[])
        try:
            return evm_interp.execute(
                code, calldata=calldata, gas_limit=gas_limit,
                value=value,
                **self._exec_args(world, address, caller_w, caller_w,
                                  False, 0))
        except EvmRevert as e:
            raise DispatchError("evm.Reverted", e.data.hex()) from e
        except EvmError as e:
            raise DispatchError("evm.ExecutionFailed", str(e)) from e

    # -- base-fee market -----------------------------------------------------
    def _note_gas(self, gas_used: int) -> None:
        self.state.put(PALLET, "block_gas",
                       self.state.get(PALLET, "block_gas", default=0)
                       + gas_used)

    def base_fee(self) -> int:
        return self.state.get(PALLET, "base_fee",
                              default=INITIAL_BASE_FEE)

    def on_initialize(self) -> None:
        """Roll the fee market: last block's demand moves the base fee
        (runtime hook, called once per block before dispatches)."""
        used = self.state.get(PALLET, "block_gas", default=0)
        base = self.base_fee()
        self.state.put(PALLET, "fee_hist", self.state.block - 1,
                       (base, used))
        stale = self.state.block - 1 - FEE_HISTORY_MAX
        if stale >= 0:
            self.state.delete(PALLET, "fee_hist", stale)
        self.state.put(PALLET, "base_fee", next_base_fee(base, used))
        self.state.put(PALLET, "block_gas", 0)

    def fee_history(self, count: int, newest: int) -> dict:
        """eth_feeHistory shape: per-block base fees + gas-used ratios
        for up to ``count`` blocks ending at ``newest``."""
        count = max(0, min(count, FEE_HISTORY_MAX))
        oldest = max(0, newest - count + 1)
        fees, ratios = [], []
        for n in range(oldest, newest + 1):
            base, used = self.state.get(PALLET, "fee_hist", n,
                                        default=(INITIAL_BASE_FEE, 0))
            fees.append(base)
            # RPC read path only (eth_feeHistory's gasUsedRatio is a
            # float by spec); never written back to consensus state
            # cesslint: disable=consensus-float
            ratios.append(round(used / GAS_CAP, 6))
        # trailing entry = block newest+1's base fee (eth_feeHistory
        # shape): the recorded one for historical windows, the live one
        # only when the window ends at the head
        nxt = self.state.get(PALLET, "fee_hist", newest + 1)
        fees.append(nxt[0] if nxt is not None else self.base_fee())
        return {"oldestBlock": oldest, "baseFeePerGas": fees,
                "gasUsedRatio": ratios}

    # -- logs (eth_getLogs backing store) ------------------------------------
    def _archive_logs(self, logs) -> None:
        if not logs:
            return
        block = self.state.block
        seq = self.state.get(PALLET, "log_seq", block, default=0)
        for lg in logs:
            self.state.put(PALLET, "logs", block, seq,
                           (lg.address, tuple(lg.topics), lg.data))
            seq += 1
        self.state.put(PALLET, "log_seq", block, seq)

    def log_seq(self, block: int) -> int:
        return self.state.get(PALLET, "log_seq", block, default=0)

    def logs_in_range(self, from_block: int, to_block: int,
                      address: bytes | None = None) -> list[dict]:
        """O(blocks in range + matches) via the per-block log_seq
        index — never a scan of the whole archive."""
        out = []
        for blk in range(max(0, from_block), to_block + 1):
            n = self.state.get(PALLET, "log_seq", blk, default=0)
            for seq in range(n):
                addr, topics, data = self.state.get(PALLET, "logs",
                                                    blk, seq)
                if address is not None and addr != address:
                    continue
                out.append({"blockNumber": blk, "logIndex": seq,
                            "address": addr, "topics": list(topics),
                            "data": data})
        return out

    def log_at(self, block: int, seq: int):
        return self.state.get(PALLET, "logs", block, seq)
