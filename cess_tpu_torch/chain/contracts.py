"""User-programmable contracts: a gas-metered VM over codec values.

The reference runs pallet-contracts (Wasm) ALONGSIDE the EVM
(runtime/src/lib.rs:1191-1207, composed at :1525).
This module is the framework-native second execution layer with the
same role split: where the EVM boundary (chain/evm.py)
executes 256-bit-word bytecode for Ethereum-shaped tooling, the
contracts VM executes structured programs over the framework's OWN
canonical value model — ints (arbitrary precision), bytes, strings and
tuples — with per-contract KV storage, host functions, and strict gas
metering. Programs are codec-encodable tuples of instructions, so
deploy/call arguments ride the normal extrinsic wire format.

Execution model: a stack machine. Each instruction is a tuple
``(op, *immediates)``; values on the stack are codec values. Control
flow is absolute instruction-index jumps, checked per step. Gas is
charged per instruction plus size-dependent costs (storage writes,
value construction), so an infinite loop burns its gas limit and
reverts — block production can never stall. All storage writes go
through the transactional ``State``; a trap/out-of-gas raises
DispatchError and the surrounding dispatch rolls back.

Instruction set (stack effects in comments):
  ("push", v)        -> v
  ("pop",)           v ->
  ("dup", i)         duplicate i-th from top (0 = top)
  ("swap",)          a b -> b a
  ("add"|"sub"|"mul"|"div"|"mod",)   a b -> (a OP b), ints only
  ("eq"|"lt"|"gt",)  a b -> bool as 0/1
  ("not",)           a -> 0/1
  ("len",)           seq -> int
  ("index",)         seq i -> seq[i]
  ("concat",)        a b -> a + b  (bytes/str/tuple)
  ("tuple", n)       v1..vn -> (v1, .., vn)
  ("jump", pc)       absolute jump
  ("jumpi", pc)      cond -> ; jump when cond truthy
  ("input",)         -> the full call-input tuple (method, *args)
  ("caller",)        -> calling account id (str)
  ("sget",)          key -> storage[key] (None when absent)
  ("sput",)          key value ->
  ("emit",)          value -> (deposits a ContractEvent)
  ("return",)        value -> halt, value is the call result
  ("revert",)        value -> halt + revert with message
"""
from __future__ import annotations

import hashlib

from .overlay import ChainedOverlay
from .state import DispatchError, State

PALLET = "contracts"
GAS_CAP = 2_000_000
DEFAULT_GAS = 200_000
MAX_CODE_INSTRS = 16_384
MAX_VALUE_BYTES = 64 * 1024     # bound on constructed values
MAX_STACK = 256

G_STEP = 1
G_SGET = 20
G_SPUT = 200
G_EMIT = 50
G_XCALL = 700
MAX_DEPTH = 32                   # nesting bound for constructed values


class _Trap(Exception):
    pass


class _Revert(Exception):
    def __init__(self, value):
        self.value = value


def _size_of(v) -> int:
    """Iterative (no Python recursion — outcome must depend on gas,
    never interpreter stack depth) size with a hard nesting cap."""
    total = 0
    stack = [(v, 0)]
    while stack:
        x, depth = stack.pop()
        if depth > MAX_DEPTH:
            raise _Trap("value nesting too deep")
        if isinstance(x, (bytes, str)):
            total += len(x)
        elif isinstance(x, tuple):
            total += 1
            stack.extend((e, depth + 1) for e in x)
        elif isinstance(x, int) and not isinstance(x, bool):
            total += 8 + abs(x).bit_length() // 8   # big ints cost more
        else:
            total += 8
    return total


def _exec(code: tuple, *, input_tuple: tuple, caller: str,
          gas_limit: int, sget, sput, emit, xcall=None) -> object:
    """``xcall(addr, method, args, fwd_gas) -> (ok, value)`` services
    cross-contract calls (never raises; the forwarded gas is consumed
    in full by the op itself); absent a host, the op pushes a failure
    tuple."""
    stack: list = []
    gas = gas_limit
    pc = 0

    def use(n: int) -> None:
        nonlocal gas
        gas -= n
        if gas < 0:
            raise _Trap("out of gas")

    def pop():
        if not stack:
            raise _Trap("stack underflow")
        return stack.pop()

    def push(v) -> None:
        if len(stack) >= MAX_STACK:
            raise _Trap("stack overflow")
        stack.append(v)

    def int2(op):
        b, a = pop(), pop()
        if not (isinstance(a, int) and isinstance(b, int)
                and not isinstance(a, bool) and not isinstance(b, bool)):
            raise _Trap(f"{op}: ints required")
        return a, b

    while pc < len(code):
        ins = code[pc]
        pc += 1
        if not (isinstance(ins, tuple) and ins
                and isinstance(ins[0], str)):
            raise _Trap(f"malformed instruction at {pc - 1}")
        op = ins[0]
        use(G_STEP)
        if op == "push":
            if len(ins) != 2:
                raise _Trap("push arity")
            sz = _size_of(ins[1])
            if sz > MAX_VALUE_BYTES:
                raise _Trap("value too large")
            use(sz)
            push(ins[1])
        elif op == "pop":
            pop()
        elif op == "dup":
            i = ins[1] if len(ins) > 1 else 0
            if not isinstance(i, int) or not 0 <= i < len(stack):
                raise _Trap("dup index")
            push(stack[-1 - i])
        elif op == "swap":
            a, b = pop(), pop()
            push(a); push(b)
        elif op in ("add", "sub", "mul", "div", "mod"):
            a, b = int2(op)
            if op == "add":
                r = a + b
            elif op == "sub":
                r = a - b
            elif op == "mul":
                use(max(a.bit_length(), b.bit_length()) // 8)
                r = a * b
            elif op == "div":
                if b == 0:
                    raise _Trap("division by zero")
                r = a // b
            else:
                if b == 0:
                    raise _Trap("division by zero")
                r = a % b
            if abs(r) >> (8 * MAX_VALUE_BYTES):
                raise _Trap("integer too large")
            push(r)
        elif op in ("eq", "lt", "gt"):
            b, a = pop(), pop()
            if op == "eq":
                push(1 if a == b else 0)
            else:
                if not (isinstance(a, int) and isinstance(b, int)):
                    raise _Trap(f"{op}: ints required")
                push(1 if ((a < b) if op == "lt" else (a > b)) else 0)
        elif op == "not":
            push(0 if pop() else 1)
        elif op == "len":
            v = pop()
            if not isinstance(v, (bytes, str, tuple)):
                raise _Trap("len: sequence required")
            push(len(v))
        elif op == "index":
            i, v = pop(), pop()
            if not isinstance(v, (bytes, str, tuple)) \
                    or not isinstance(i, int) or not 0 <= i < len(v):
                raise _Trap("index out of range")
            push(v[i])
        elif op == "concat":
            b, a = pop(), pop()
            if not (type(a) is type(b)
                    and isinstance(a, (bytes, str, tuple))):
                raise _Trap("concat: matching sequences required")
            if _size_of(a) + _size_of(b) > MAX_VALUE_BYTES:
                raise _Trap("value too large")
            use(_size_of(a) + _size_of(b))
            push(a + b)
        elif op == "tuple":
            n = ins[1] if len(ins) > 1 else 0
            if not isinstance(n, int) or not 0 <= n <= len(stack):
                raise _Trap("tuple arity")
            vs = tuple(reversed([pop() for _ in range(n)]))
            sz = _size_of(vs)
            if sz > MAX_VALUE_BYTES:
                raise _Trap("value too large")
            use(sz)
            push(vs)
        elif op in ("jump", "jumpi"):
            tgt = ins[1] if len(ins) > 1 else -1
            if op == "jumpi" and not pop():
                continue
            if not isinstance(tgt, int) or not 0 <= tgt < len(code):
                raise _Trap(f"bad jump target {tgt}")
            pc = tgt
        elif op == "input":
            push(input_tuple)
        elif op == "caller":
            push(caller)
        elif op == "sget":
            v = sget(pop())
            # loaded bytes cost gas like constructed bytes do, so a
            # cheap loop can't stream unbounded state through the VM
            use(G_SGET + _size_of(v))
            push(v)
        elif op == "sput":
            v, k = pop(), pop()
            if _size_of(v) > MAX_VALUE_BYTES:
                raise _Trap("value too large")
            use(G_SPUT + _size_of(v) + _size_of(k))
            sput(k, v)
        elif op == "emit":
            v = pop()
            use(G_EMIT + _size_of(v))
            emit(v)
        elif op == "xcall":
            # cross-contract call (pallet-contracts call-chain role):
            # pops gas, args(tuple), method(str), address(bytes);
            # pushes (1, result) on success, (0, reason) on failure —
            # an inner revert/trap NEVER traps the caller
            use(G_XCALL)
            g, ar, m, a = pop(), pop(), pop(), pop()
            if not (isinstance(g, int) and not isinstance(g, bool)
                    and g > 0 and isinstance(ar, tuple)
                    and isinstance(m, str) and isinstance(a, bytes)):
                raise _Trap("xcall: (addr, method, args, gas) required")
            # 63/64 forwarding; the forwarded budget is consumed in
            # full (no refund) — a strict upper bound, kept simple
            fwd = min(g, gas - gas // 64)
            use(fwd)
            if xcall is None:
                push((0, "no host"))
            else:
                ok, val = xcall(a, m, ar, fwd)
                push((1 if ok else 0, val))
        elif op == "return":
            return pop()
        elif op == "revert":
            raise _Revert(pop())
        else:
            raise _Trap(f"unknown op {op!r}")
    return None


def _storage_key(k) -> bytes:
    from .. import codec

    return hashlib.sha256(codec.encode(k)).digest()


def code_hash(code: tuple) -> bytes:
    """THE canonical serialized bytecode identity: sha256 of the codec
    encoding of the instruction tuple. The codec encoding is the wire
    format third-party toolchains target (deterministic, versioned,
    schema-checked on decode), so a code hash names exactly one
    byte-identical program on every replica."""
    from .. import codec

    return hashlib.sha256(b"cvm-code:" + codec.encode(code)).digest()


class Contracts:
    """The pallet boundary: upload/deploy/instantiate/call/query over
    the VM, matching evm.py's surface shape + pallet-contracts'
    code-hash model (runtime/src/lib.rs:1191-1207: upload_code,
    instantiate_with_code, instantiate — code stored ONCE per hash,
    contracts point at it)."""

    def __init__(self, state: State):
        self.state = state

    def _check_gas(self, gas_limit) -> int:
        if not isinstance(gas_limit, int) or gas_limit <= 0:
            raise DispatchError("contracts.InvalidGas")
        return min(gas_limit, GAS_CAP)

    @staticmethod
    def _check_code(code) -> None:
        if not (isinstance(code, tuple) and 0 < len(code)
                <= MAX_CODE_INSTRS
                and all(isinstance(i, tuple) and i
                        and isinstance(i[0], str) for i in code)):
            raise DispatchError("contracts.InvalidCode")

    # -- code store (pallet-contracts upload_code / CodeStorage) -------------
    def upload_code(self, who: str, code: tuple) -> bytes:
        """Store a program under its canonical hash (dedup: a second
        upload of identical code is a no-op returning the same hash).
        Returns the code hash for later instantiate()."""
        self._check_code(code)
        h = code_hash(code)
        if not self.state.contains(PALLET, "code_store", h):
            self.state.put(PALLET, "code_store", h, code)
            self.state.deposit_event(PALLET, "CodeStored", who=who,
                                     code_hash=h, instrs=len(code))
        return h

    def code_by_hash(self, h: bytes):
        return self.state.get(PALLET, "code_store", h)

    def _new_address(self, who: str) -> bytes:
        nonce = self.state.get(PALLET, "nonce", who, default=0)
        self.state.put(PALLET, "nonce", who, nonce + 1)
        return hashlib.sha256(b"cvm-create:" + who.encode()
                              + nonce.to_bytes(8, "little")).digest()[:20]

    def deploy(self, who: str, code: tuple) -> bytes:
        """instantiate_with_code: upload (deduped) + instantiate in
        one dispatch; constructors are an explicit follow-up
        ``call(addr, "init", ...)`` by convention (keeps deploy cost
        independent of program behavior, so no gas parameter).
        Returns the address."""
        h = self.upload_code(who, code)
        return self._instantiate(who, h, len(code))

    def instantiate(self, who: str, h: bytes) -> bytes:
        """Deploy-by-hash against previously uploaded code — the wire
        carries 32 bytes instead of the whole program."""
        code = self.code_by_hash(h) if isinstance(h, bytes) else None
        if code is None:
            raise DispatchError("contracts.CodeNotFound")
        return self._instantiate(who, h, len(code))

    def _instantiate(self, who: str, h: bytes, instrs: int) -> bytes:
        addr = self._new_address(who)
        self.state.put(PALLET, "code", addr, h)   # hash, not the body
        self.state.deposit_event(PALLET, "Deployed", who=who,
                                 address=addr, code_hash=h,
                                 instrs=instrs)
        return addr

    def code_at(self, address: bytes):
        ref = self.state.get(PALLET, "code", address)
        if isinstance(ref, bytes):                # hash indirection
            return self.code_by_hash(ref)
        return ref                                # pre-v2 inline body

    def call(self, who: str, address: bytes, method: str,
             args: tuple = (), gas_limit: int = DEFAULT_GAS):
        """Execute ``method(*args)``; storage writes and events commit
        with the surrounding dispatch transaction."""
        if not isinstance(method, str) or not isinstance(args, tuple):
            raise DispatchError("contracts.InvalidCall")
        gas_limit = self._check_gas(gas_limit)
        out = self._run(who, address, (method, *args), gas_limit)
        self.state.deposit_event(PALLET, "Called", who=who,
                                 address=address, method=method)
        return out

    def query(self, address: bytes, method: str, args: tuple = (),
              caller: str = "", gas_limit: int = DEFAULT_GAS):
        """Read-only call: storage reads from chain state, writes to a
        throwaway overlay, no events."""
        if not isinstance(method, str) or not isinstance(args, tuple):
            raise DispatchError("contracts.InvalidCall")
        gas_limit = self._check_gas(gas_limit)
        # the root session is simply never committed: every frame's
        # writes and events — inner xcalls included — are thrown away
        return self._run(caller, address, (method, *args), gas_limit,
                         commit=False)

    MAX_XCALL_DEPTH = 8

    class _Session(ChainedOverlay):
        """Frame-chained contract storage (keys are
        (address, hashed-slot)) PLUS pending events — events follow
        the same discipline as writes, so a reverted subtree's events
        vanish with it. See chain/overlay.py (shared with the EVM)."""

        def __init__(self, contracts: "Contracts", parent=None):
            st = contracts.state
            super().__init__(
                root_get=lambda ak: st.get(PALLET, "storage", ak[0],
                                           ak[1]),
                root_put=lambda ak, v: st.put(PALLET, "storage", ak[0],
                                              ak[1], v),
                parent=parent)
            self.c = contracts
            self.events: list[tuple[bytes, object]] = []

        def hooks(self, a: bytes):
            return (lambda k: self.get((a, _storage_key(k))),
                    lambda k, v: self.put((a, _storage_key(k)), v),
                    lambda v: self.events.append((a, v)))

        def commit(self) -> None:
            super().commit()
            if self.parent is not None:
                self.parent.events.extend(self.events)
            else:
                for a, v in self.events:
                    self.c.state.deposit_event(PALLET, "ContractEvent",
                                               address=a, data=v)

    # -- engine bridge -------------------------------------------------------
    def _run(self, who: str, address: bytes, input_tuple: tuple,
             gas_limit: int, session: "Contracts._Session | None" = None,
             depth: int = 0, commit: bool = True):
        """One exec bridge for call, query, and recursive xcall frames
        (see _Session for the commit discipline). ``commit=False``
        (query) discards the root session."""
        code = self.code_at(address)
        if code is None:
            raise DispatchError("contracts.NoContract")
        if session is None:
            session = Contracts._Session(self)
        sget, sput, emit = session.hooks(address)

        def xcall(a: bytes, method: str, args: tuple, fwd: int):
            if depth >= self.MAX_XCALL_DEPTH:
                return 0, "call depth exceeded"
            if self.code_at(a) is None:
                return 0, "no contract"
            child = Contracts._Session(self, parent=session)
            try:
                out = self._run(
                    # the CALLER of the inner frame is this contract
                    "contract:" + address.hex(), a, (method, *args),
                    fwd, session=child, depth=depth + 1, commit=False)
            except DispatchError as e:
                return 0, str(e)
            child.commit()             # into the PARENT frame's session
            return 1, out

        try:
            out = _exec(code, input_tuple=input_tuple, caller=who,
                        gas_limit=gas_limit, sget=sget, sput=sput,
                        emit=emit, xcall=xcall)
        except _Revert as e:
            raise DispatchError("contracts.Reverted", repr(e.value)) from e
        except _Trap as e:
            raise DispatchError("contracts.Trapped", str(e)) from e
        if commit and session.parent is None:
            session.commit()
        return out
