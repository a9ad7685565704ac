"""A real EVM bytecode interpreter behind the evm boundary.

The reference runs the full Frontier stack (pallet-evm/pallet-ethereum,
runtime/src/lib.rs:1310-1380) with Eth RPC
(node/src/rpc.rs:229-328). This is the framework-native execution
engine for the same boundary: a 256-bit word stack machine with gas
metering, covering the core opcode set — arithmetic / comparison /
bitwise, SHA3, environment (ADDRESS/CALLER/CALLVALUE/CALLDATA*/CODE*),
stack / memory / storage, control flow (JUMP/JUMPI/JUMPDEST/PC), PUSH /
DUP / SWAP, LOG0-4, and RETURN / REVERT / STOP / INVALID — enough to
run hand-assembled or simple compiled contracts (an ERC-20-style token
round-trips deploy -> transfer -> balanceOf through it, tests/
test_evm.py).

Deliberate deviations from mainnet EVM, documented once:
- SHA3 is NIST sha3_256 (hashlib), not Keccak-256 — contracts compiled
  for Ethereum that depend on specific keccak digests will differ; the
  dispatch/storage-slot PATTERN (hash-derived slots) works identically.
- Gas costs are simplified tiers (VERYLOW/LOW/MID/HIGH + SSTORE/SLOAD/
  LOG/SHA3/memory expansion), not the full Berlin/London schedule. Out
  of gas always consumes the limit and reverts state — an infinite
  loop can never stall block production (tested).
- Inter-contract CALL / STATICCALL / DELEGATECALL and CREATE/CREATE2
  run through host callbacks (evm.py recursion with
  commit-on-success overlays, depth cap, 63/64 gas forwarding).
  Value-carrying CALL moves EVM-domain balance with full revert
  semantics; BALANCE/SELFBALANCE read through the ``balance`` hook.
  CREATE2 addresses derive with sha256 (not keccak, per the SHA3
  deviation above): sha256("evm-create2:" || creator20 || salt32 ||
  sha256(init))[:20] — deterministic and predictable by contracts
  using the same formula, which is the property EIP-1014 exists for.
  The creator's nonce bump for CREATE/CREATE2 persists in the parent
  frame even when init reverts (mainnet semantics; geth orders the
  balance check before the bump, mirrored here) — a retried create
  derives a fresh address rather than reusing the reverted one.
- Precompiles 0x1-0x4 (ecrecover / sha256 / ripemd160 / identity)
  are serviced by the call host in evm.py; ecrecover's address
  derivation is sha3_256-based (crypto/secp256k1.py docstring).

Execution state (storage, logs) is written through the transactional
KV ``State``, so the runtime's dispatch transactionality applies:
a REVERT or OutOfGas inside ``Evm.call`` raises DispatchError and the
surrounding state tx rolls everything back.
"""
from __future__ import annotations

import dataclasses
import hashlib

U256 = 1 << 256
MASK256 = U256 - 1
MAX_MEM = 1 << 22          # 4 MiB memory hard cap (anti-DoS)
MAX_STACK = 1024

# simplified gas schedule
G_BASE = 2
G_VERYLOW = 3
G_LOW = 5
G_MID = 8
G_HIGH = 10
G_EXP = 50
G_SHA3 = 30
G_SHA3_WORD = 6
G_SLOAD = 200
G_SSTORE_SET = 20_000
G_SSTORE_RESET = 5_000
G_LOG = 375
G_LOG_TOPIC = 375
G_LOG_DATA = 8
G_MEM_WORD = 3
G_COPY_WORD = 3
G_CALL = 700
G_CREATE = 32_000
G_BALANCE = 400
G_EXT = 700


class EvmRevert(Exception):
    def __init__(self, data: bytes, gas_used: int = 0):
        self.data = data
        self.gas_used = gas_used


class EvmError(Exception):
    """Exceptional halt: out of gas, bad jump, stack violation,
    invalid opcode. Consumes all gas; state reverts."""


@dataclasses.dataclass
class Log:
    address: bytes
    topics: tuple[bytes, ...]
    data: bytes


@dataclasses.dataclass
class ExecResult:
    output: bytes
    gas_used: int
    logs: list[Log]


def sha3(data: bytes) -> bytes:
    return hashlib.sha3_256(data).digest()


class _Memory:
    def __init__(self):
        self.buf = bytearray()

    def _expand(self, end: int, gas) -> None:
        if end > MAX_MEM:
            raise EvmError("memory cap exceeded")
        if end > len(self.buf):
            new_words = (end + 31) // 32
            old_words = (len(self.buf) + 31) // 32
            gas.use(G_MEM_WORD * (new_words - old_words))
            self.buf.extend(b"\0" * (new_words * 32 - len(self.buf)))

    def load(self, off: int, gas) -> int:
        self._expand(off + 32, gas)
        return int.from_bytes(self.buf[off:off + 32], "big")

    def store(self, off: int, value: int, gas) -> None:
        self._expand(off + 32, gas)
        self.buf[off:off + 32] = value.to_bytes(32, "big")

    def store8(self, off: int, value: int, gas) -> None:
        self._expand(off + 1, gas)
        self.buf[off] = value & 0xFF

    def write(self, off: int, data: bytes, gas) -> None:
        if data:
            self._expand(off + len(data), gas)
            self.buf[off:off + len(data)] = data

    def read(self, off: int, size: int, gas) -> bytes:
        if size == 0:
            return b""
        self._expand(off + size, gas)
        return bytes(self.buf[off:off + size])


class _Gas:
    def __init__(self, limit: int):
        self.limit = limit
        self.used = 0

    def use(self, n: int) -> None:
        self.used += n
        if self.used > self.limit:
            raise EvmError("out of gas")

    @property
    def remaining(self) -> int:
        return self.limit - self.used


def _signed(x: int) -> int:
    return x - U256 if x >> 255 else x


def _valid_jumpdests(code: bytes) -> set[int]:
    """JUMPDEST positions, skipping PUSH immediates."""
    dests, i = set(), 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            dests.add(i)
        i += (op - 0x5F + 1) if 0x60 <= op <= 0x7F else 1
    return dests


def execute(code: bytes, *, calldata: bytes = b"", caller: bytes = b"",
            address: bytes = b"", value: int = 0, gas_limit: int = 1_000_000,
            sload=None, sstore=None, static: bool = False,
            call_host=None, create_host=None, balance=None,
            extcode=None, origin: bytes = b"",
            env: dict | None = None) -> ExecResult:
    """Run ``code`` to completion.

    sload(key_int) -> int and sstore(key_int, value_int) bridge contract
    storage to the chain KV; both default to an in-memory dict (pure
    eth_call-style simulation).

    ``call_host(kind, to20, data, fwd_gas, value)`` services the
    inter-contract CALL family (kind in "call"/"static"/"delegate");
    it returns (success, returndata, gas_spent, inner_logs) and NEVER
    raises. Absent a host, CALL-family opcodes fail cleanly (push 0).
    ``static`` makes SSTORE/LOG*/CREATE* exceptional halts (STATICCALL
    frame).

    ``create_host(init, value, salt_or_None, fwd_gas)`` services
    CREATE/CREATE2; returns (addr_int_or_0, returndata, gas_spent,
    inner_logs) and never raises — addr 0 means the creation failed
    (returndata then carries the init code's revert payload, EVM
    semantics). ``balance(addr20) -> int`` backs BALANCE/SELFBALANCE
    (0 without a host). ``extcode(addr20) -> bytes`` backs
    EXTCODESIZE/EXTCODECOPY/EXTCODEHASH. ``env`` supplies block
    context: number, timestamp, chainid, basefee, gasprice, coinbase.

    Raises EvmRevert (REVERT opcode, gas charged so far) or EvmError
    (exceptional halt, all gas consumed).
    """
    local: dict[int, int] = {}
    sload = sload or (lambda k: local.get(k, 0))
    sstore = sstore or local.__setitem__
    balance = balance or (lambda a: 0)
    extcode = extcode or (lambda a: b"")
    env = env or {}
    origin = origin or caller

    gas = _Gas(gas_limit)
    mem = _Memory()
    stack: list[int] = []
    logs: list[Log] = []
    dests = _valid_jumpdests(code)
    returndata = b""               # last CALL-family return buffer
    pc = 0

    def push(v: int) -> None:
        if len(stack) >= MAX_STACK:
            raise EvmError("stack overflow")
        stack.append(v & MASK256)

    def pop() -> int:
        if not stack:
            raise EvmError("stack underflow")
        return stack.pop()

    while pc < len(code):
        op = code[pc]
        pc += 1
        # -- PUSH / DUP / SWAP families ----------------------------------
        if 0x60 <= op <= 0x7F:                      # PUSH1..PUSH32
            n = op - 0x5F
            gas.use(G_VERYLOW)
            # missing code bytes read as zeros (EVM right-pads)
            push(int.from_bytes(code[pc:pc + n].ljust(n, b"\0"), "big"))
            pc += n
        elif 0x80 <= op <= 0x8F:                    # DUP1..DUP16
            n = op - 0x7F
            gas.use(G_VERYLOW)
            if len(stack) < n:
                raise EvmError("stack underflow")
            push(stack[-n])
        elif 0x90 <= op <= 0x9F:                    # SWAP1..SWAP16
            n = op - 0x8F
            gas.use(G_VERYLOW)
            if len(stack) < n + 1:
                raise EvmError("stack underflow")
            stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
        # -- halting ------------------------------------------------------
        elif op == 0x00:                            # STOP
            return ExecResult(b"", gas.used, logs)
        elif op == 0xF3:                            # RETURN
            off, size = pop(), pop()
            out = mem.read(off, size, gas)
            return ExecResult(out, gas.used, logs)
        elif op == 0xFD:                            # REVERT
            off, size = pop(), pop()
            raise EvmRevert(mem.read(off, size, gas), gas.used)
        # -- arithmetic ---------------------------------------------------
        elif op == 0x01:                            # ADD
            gas.use(G_VERYLOW); push(pop() + pop())
        elif op == 0x02:                            # MUL
            gas.use(G_LOW); push(pop() * pop())
        elif op == 0x03:                            # SUB
            gas.use(G_VERYLOW); a, b = pop(), pop(); push(a - b)
        elif op == 0x04:                            # DIV
            gas.use(G_LOW); a, b = pop(), pop(); push(a // b if b else 0)
        elif op == 0x05:                            # SDIV
            gas.use(G_LOW)
            a, b = _signed(pop()), _signed(pop())
            push(0 if b == 0 else abs(a) // abs(b)
                 * (1 if (a < 0) == (b < 0) else -1))
        elif op == 0x06:                            # MOD
            gas.use(G_LOW); a, b = pop(), pop(); push(a % b if b else 0)
        elif op == 0x07:                            # SMOD
            gas.use(G_LOW)
            a, b = _signed(pop()), _signed(pop())
            push(0 if b == 0 else abs(a) % abs(b) * (1 if a >= 0 else -1))
        elif op == 0x08:                            # ADDMOD
            gas.use(G_MID); a, b, n = pop(), pop(), pop()
            push((a + b) % n if n else 0)
        elif op == 0x09:                            # MULMOD
            gas.use(G_MID); a, b, n = pop(), pop(), pop()
            push((a * b) % n if n else 0)
        elif op == 0x0A:                            # EXP
            a, e = pop(), pop()
            gas.use(G_EXP + 50 * ((e.bit_length() + 7) // 8))
            push(pow(a, e, U256))
        # -- comparison / bitwise ----------------------------------------
        elif op == 0x10:                            # LT
            gas.use(G_VERYLOW); a, b = pop(), pop(); push(int(a < b))
        elif op == 0x11:                            # GT
            gas.use(G_VERYLOW); a, b = pop(), pop(); push(int(a > b))
        elif op == 0x12:                            # SLT
            gas.use(G_VERYLOW)
            a, b = _signed(pop()), _signed(pop()); push(int(a < b))
        elif op == 0x13:                            # SGT
            gas.use(G_VERYLOW)
            a, b = _signed(pop()), _signed(pop()); push(int(a > b))
        elif op == 0x14:                            # EQ
            gas.use(G_VERYLOW); push(int(pop() == pop()))
        elif op == 0x15:                            # ISZERO
            gas.use(G_VERYLOW); push(int(pop() == 0))
        elif op == 0x16:                            # AND
            gas.use(G_VERYLOW); push(pop() & pop())
        elif op == 0x17:                            # OR
            gas.use(G_VERYLOW); push(pop() | pop())
        elif op == 0x18:                            # XOR
            gas.use(G_VERYLOW); push(pop() ^ pop())
        elif op == 0x19:                            # NOT
            gas.use(G_VERYLOW); push(~pop())
        elif op == 0x1A:                            # BYTE
            gas.use(G_VERYLOW); i, x = pop(), pop()
            push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
        elif op == 0x1B:                            # SHL
            gas.use(G_VERYLOW); s, x = pop(), pop()
            push(x << s if s < 256 else 0)
        elif op == 0x1C:                            # SHR
            gas.use(G_VERYLOW); s, x = pop(), pop()
            push(x >> s if s < 256 else 0)
        elif op == 0x1D:                            # SAR
            gas.use(G_VERYLOW); s, x = pop(), pop()
            push((_signed(x) >> min(s, 255)))
        # -- SHA3 ---------------------------------------------------------
        elif op == 0x20:                            # SHA3 (sha3_256 here)
            off, size = pop(), pop()
            gas.use(G_SHA3 + G_SHA3_WORD * ((size + 31) // 32))
            push(int.from_bytes(sha3(mem.read(off, size, gas)), "big"))
        # -- environment --------------------------------------------------
        elif op == 0x30:                            # ADDRESS
            gas.use(G_BASE); push(int.from_bytes(address, "big"))
        elif op == 0x31:                            # BALANCE
            gas.use(G_BALANCE)
            push(balance(pop().to_bytes(32, "big")[-20:]))
        elif op == 0x32:                            # ORIGIN
            gas.use(G_BASE); push(int.from_bytes(origin, "big"))
        elif op == 0x33:                            # CALLER
            gas.use(G_BASE); push(int.from_bytes(caller, "big"))
        elif op == 0x34:                            # CALLVALUE
            gas.use(G_BASE); push(value)
        elif op == 0x35:                            # CALLDATALOAD
            gas.use(G_VERYLOW); off = pop()
            chunk = calldata[off:off + 32] if off < len(calldata) else b""
            push(int.from_bytes(chunk.ljust(32, b"\0"), "big"))
        elif op == 0x36:                            # CALLDATASIZE
            gas.use(G_BASE); push(len(calldata))
        elif op == 0x37:                            # CALLDATACOPY
            doff, soff, size = pop(), pop(), pop()
            gas.use(G_VERYLOW + G_COPY_WORD * ((size + 31) // 32))
            if size:
                # cap + expansion gas BEFORE materializing the padded
                # chunk: a huge size must fail here, not after a
                # transient multi-MB ljust allocation
                mem._expand(doff + size, gas)
                chunk = calldata[soff:soff + size] \
                    if soff < len(calldata) else b""
                mem.write(doff, chunk.ljust(size, b"\0"), gas)
        elif op == 0x38:                            # CODESIZE
            gas.use(G_BASE); push(len(code))
        elif op == 0x39:                            # CODECOPY
            doff, soff, size = pop(), pop(), pop()
            gas.use(G_VERYLOW + G_COPY_WORD * ((size + 31) // 32))
            if size:
                mem._expand(doff + size, gas)
                chunk = code[soff:soff + size] if soff < len(code) else b""
                mem.write(doff, chunk.ljust(size, b"\0"), gas)
        elif op == 0x3A:                            # GASPRICE
            gas.use(G_BASE); push(env.get("gasprice", 0))
        elif op == 0x3B:                            # EXTCODESIZE
            gas.use(G_EXT)
            push(len(extcode(pop().to_bytes(32, "big")[-20:])))
        elif op == 0x3C:                            # EXTCODECOPY
            a20 = pop().to_bytes(32, "big")[-20:]
            doff, soff, size = pop(), pop(), pop()
            gas.use(G_EXT + G_COPY_WORD * ((size + 31) // 32))
            if size:
                mem._expand(doff + size, gas)
                xc = extcode(a20)
                chunk = xc[soff:soff + size] if soff < len(xc) else b""
                mem.write(doff, chunk.ljust(size, b"\0"), gas)
        elif op == 0x3F:                            # EXTCODEHASH
            gas.use(G_EXT)
            xc = extcode(pop().to_bytes(32, "big")[-20:])
            push(int.from_bytes(sha3(xc), "big") if xc else 0)
        elif op == 0x3D:                            # RETURNDATASIZE
            gas.use(G_BASE); push(len(returndata))
        elif op == 0x3E:                            # RETURNDATACOPY
            doff, soff, size = pop(), pop(), pop()
            gas.use(G_VERYLOW + G_COPY_WORD * ((size + 31) // 32))
            if soff + size > len(returndata):       # spec: exceptional
                raise EvmError("returndatacopy out of bounds")
            if size:
                mem.write(doff, returndata[soff:soff + size], gas)
        # -- block context -------------------------------------------------
        elif op == 0x41:                            # COINBASE
            gas.use(G_BASE)
            push(int.from_bytes(env.get("coinbase", b""), "big"))
        elif op == 0x42:                            # TIMESTAMP
            gas.use(G_BASE); push(env.get("timestamp", 0))
        elif op == 0x43:                            # NUMBER
            gas.use(G_BASE); push(env.get("number", 0))
        elif op == 0x46:                            # CHAINID
            gas.use(G_BASE); push(env.get("chainid", 0))
        elif op == 0x47:                            # SELFBALANCE
            gas.use(G_LOW); push(balance(address))
        elif op == 0x48:                            # BASEFEE
            gas.use(G_BASE); push(env.get("basefee", 0))
        # -- stack / memory / storage ------------------------------------
        elif op == 0x50:                            # POP
            gas.use(G_BASE); pop()
        elif op == 0x51:                            # MLOAD
            gas.use(G_VERYLOW); push(mem.load(pop(), gas))
        elif op == 0x52:                            # MSTORE
            gas.use(G_VERYLOW); off, v = pop(), pop()
            mem.store(off, v, gas)
        elif op == 0x53:                            # MSTORE8
            gas.use(G_VERYLOW); off, v = pop(), pop()
            mem.store8(off, v, gas)
        elif op == 0x54:                            # SLOAD
            gas.use(G_SLOAD); push(sload(pop()))
        elif op == 0x55:                            # SSTORE
            if static:
                raise EvmError("SSTORE in static context")
            k, v = pop(), pop()
            gas.use(G_SSTORE_SET if sload(k) == 0 and v != 0
                    else G_SSTORE_RESET)
            sstore(k, v)
        elif op == 0x56:                            # JUMP
            gas.use(G_MID); dst = pop()
            if dst not in dests:
                raise EvmError(f"bad jump dest {dst}")
            pc = dst
        elif op == 0x57:                            # JUMPI
            gas.use(G_HIGH); dst, cond = pop(), pop()
            if cond:
                if dst not in dests:
                    raise EvmError(f"bad jump dest {dst}")
                pc = dst
        elif op == 0x58:                            # PC
            gas.use(G_BASE); push(pc - 1)
        elif op == 0x59:                            # MSIZE
            gas.use(G_BASE); push(len(mem.buf))
        elif op == 0x5A:                            # GAS
            gas.use(G_BASE); push(gas.remaining)
        elif op == 0x5B:                            # JUMPDEST
            gas.use(1)
        # -- logs ---------------------------------------------------------
        elif 0xA0 <= op <= 0xA4:                    # LOG0..LOG4
            if static:
                raise EvmError("LOG in static context")
            ntopics = op - 0xA0
            off, size = pop(), pop()
            topics = tuple(pop().to_bytes(32, "big")
                           for _ in range(ntopics))
            gas.use(G_LOG + G_LOG_TOPIC * ntopics + G_LOG_DATA * size)
            logs.append(Log(address=address, topics=topics,
                            data=mem.read(off, size, gas)))
        # -- CREATE / CREATE2 (serviced by create_host) -------------------
        elif op in (0xF0, 0xF5):                    # CREATE/CREATE2
            if static:
                raise EvmError("CREATE in static context")
            gas.use(G_CREATE)
            val, off, size = pop(), pop(), pop()
            salt = pop().to_bytes(32, "big") if op == 0xF5 else None
            init = mem.read(off, size, gas)
            fwd = gas.remaining - gas.remaining // 64   # EIP-150
            if create_host is None:
                addr_int, retdata, spent, inner_logs = 0, b"", 0, []
            else:
                addr_int, retdata, spent, inner_logs = create_host(
                    init, val, salt, fwd)
            gas.use(min(spent, fwd))
            returndata = retdata            # revert payload on failure
            if addr_int:
                logs.extend(inner_logs)
            push(addr_int)
        # -- inter-contract calls (serviced by call_host) -----------------
        elif op in (0xF1, 0xF4, 0xFA):              # CALL/DELEGATECALL/
            gas.use(G_CALL)                         # STATICCALL
            gas_req, to = pop(), pop()
            val = pop() if op == 0xF1 else 0
            in_off, in_size = pop(), pop()
            out_off, out_size = pop(), pop()
            if static and op == 0xF1 and val:
                raise EvmError("value transfer in static context")
            if op == 0xF4:
                val = value     # apparent value rides along, no transfer
            data = mem.read(in_off, in_size, gas)
            if out_size:
                mem._expand(out_off + out_size, gas)
            # 63/64 forwarding rule bounds recursion cost
            fwd = min(gas_req, gas.remaining - gas.remaining // 64)
            kind = {0xF1: "call", 0xF4: "delegate", 0xFA: "static"}[op]
            if call_host is None:
                success, retdata, spent, inner_logs = 0, b"", 0, []
            else:
                success, retdata, spent, inner_logs = call_host(
                    kind, to.to_bytes(32, "big")[-20:], data, fwd, val)
            gas.use(min(spent, fwd))
            returndata = retdata
            if success:
                logs.extend(inner_logs)
            if out_size:
                mem.write(out_off,
                          retdata[:out_size].ljust(out_size, b"\0"), gas)
            push(1 if success else 0)
        else:
            raise EvmError(f"invalid/unsupported opcode 0x{op:02x}")
    return ExecResult(b"", gas.used, logs)


def initcode(runtime: bytes, ctor: bytes = b"") -> bytes:
    """Standard CREATE wrapper: INIT code that runs ``ctor`` (e.g. a
    mint-to-CALLER sequence, ending with an empty stack), CODECOPYs
    ``runtime`` into memory and RETURNs it — what Solidity
    constructors compile to."""
    # tail: PUSH2 len, PUSH2 off, PUSH1 0, CODECOPY,
    #       PUSH2 len, PUSH1 0, RETURN   -> 15 bytes
    off = len(ctor) + 15
    return ctor + bytes([
        0x61, *len(runtime).to_bytes(2, "big"),
        0x61, *off.to_bytes(2, "big"),
        0x60, 0x00, 0x39,
        0x61, *len(runtime).to_bytes(2, "big"),
        0x60, 0x00, 0xF3,
    ]) + runtime


# -- tiny assembler (tests + hand-written contracts) -----------------------

OPS = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "SDIV": 0x05, "MOD": 0x06, "SMOD": 0x07, "ADDMOD": 0x08,
    "MULMOD": 0x09, "EXP": 0x0A, "LT": 0x10, "GT": 0x11, "SLT": 0x12,
    "SGT": 0x13, "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16, "OR": 0x17,
    "XOR": 0x18, "NOT": 0x19, "BYTE": 0x1A, "SHL": 0x1B, "SHR": 0x1C,
    "SAR": 0x1D, "SHA3": 0x20, "ADDRESS": 0x30, "CALLER": 0x33,
    "CALLVALUE": 0x34, "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36,
    "CALLDATACOPY": 0x37, "CODESIZE": 0x38, "CODECOPY": 0x39,
    "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E,
    "BALANCE": 0x31, "ORIGIN": 0x32, "GASPRICE": 0x3A,
    "EXTCODESIZE": 0x3B, "EXTCODECOPY": 0x3C, "EXTCODEHASH": 0x3F,
    "COINBASE": 0x41, "TIMESTAMP": 0x42, "NUMBER": 0x43,
    "CHAINID": 0x46, "SELFBALANCE": 0x47, "BASEFEE": 0x48,
    "CREATE": 0xF0, "CREATE2": 0xF5,
    "CALL": 0xF1, "DELEGATECALL": 0xF4, "STATICCALL": 0xFA,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52,
    "MSTORE8": 0x53, "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56,
    "JUMPI": 0x57, "PC": 0x58, "MSIZE": 0x59, "GAS": 0x5A,
    "JUMPDEST": 0x5B, "LOG0": 0xA0, "LOG1": 0xA1, "LOG2": 0xA2,
    "LOG3": 0xA3, "LOG4": 0xA4, "RETURN": 0xF3, "REVERT": 0xFD,
    "INVALID": 0xFE,
}
OPS.update({f"DUP{i}": 0x7F + i for i in range(1, 17)})
OPS.update({f"SWAP{i}": 0x8F + i for i in range(1, 17)})


def asm(*items) -> bytes:
    """Assemble a contract: strings are opcodes, ints become minimal
    PUSHn, ("label", name) defines a jump target, ("push_label", name)
    pushes its (2-byte) position. Two passes resolve labels; an
    undefined label is an assembly-time error."""
    labels: dict[str, int] = {}
    used: set[str] = set()
    out = bytearray()
    for final in (False, True):
        out = bytearray()
        for it in items:
            if isinstance(it, str):
                out.append(OPS[it])
            elif isinstance(it, int):
                n = max(1, (it.bit_length() + 7) // 8)
                out.append(0x5F + n)
                out.extend(it.to_bytes(n, "big"))
            elif isinstance(it, bytes):
                out.extend(it)
            elif isinstance(it, tuple) and it[0] == "label":
                labels[it[1]] = len(out)
                out.append(OPS["JUMPDEST"])
            elif isinstance(it, tuple) and it[0] == "push_label":
                used.add(it[1])
                if final and it[1] not in labels:
                    raise ValueError(f"undefined label {it[1]!r}")
                out.append(0x61)   # PUSH2
                out.extend(labels.get(it[1], 0).to_bytes(2, "big"))
            else:
                raise ValueError(f"bad asm item {it!r}")
    missing = used - labels.keys()
    if missing:
        raise ValueError(f"undefined labels {sorted(missing)}")
    return bytes(out)
