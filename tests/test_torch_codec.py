"""The port's wire codec (cess_tpu_torch.codec) against the reference's
(cess_tpu.codec), on the CPU.

Tolerance 0: encoded bytes are protocol facts (signatures and state
roots are taken over them). For every dataclass the port registers (its
storage-audit plane's, its runtime's and its node's), the port's bytes equal the
reference's, and a blob encoded by either package decodes in the other
to equal fields. The reference's malformed inputs
(tests/test_codec.py: the depth bound, truncation, trailing bytes,
unknown tags and names) fail the same way in both.
"""
import dataclasses

import numpy as np
import pytest

import cess_tpu.chain.audit  # noqa: F401  (registers the slice's types)
import cess_tpu.chain.file_bank  # noqa: F401
import cess_tpu.chain.runtime  # noqa: F401
import cess_tpu.chain.tee_worker  # noqa: F401
import cess_tpu.node.consensus  # noqa: F401
import cess_tpu.node.network  # noqa: F401
import cess_tpu.node.offchain  # noqa: F401
from cess_tpu import codec as jcodec
import cess_tpu_torch.chain.audit  # noqa: F401
import cess_tpu_torch.chain.file_bank  # noqa: F401
import cess_tpu_torch.chain.runtime  # noqa: F401
import cess_tpu_torch.chain.tee_worker  # noqa: F401
import cess_tpu_torch.node.consensus  # noqa: F401
import cess_tpu_torch.node.network  # noqa: F401
import cess_tpu_torch.node.offchain  # noqa: F401
from cess_tpu_torch import codec as pcodec

SLICE_TYPES = ["AttestationReport", "ChallengeInfo", "DealInfo", "Event",
               "FileInfo", "MinerInfo", "MinerSnapshot", "NetSnapshot",
               "OwnedSpace", "Proof", "ProveInfo", "RestoralOrder",
               "RestoralTarget", "RewardOrder", "RsaPublicKey", "SegmentInfo",
               "SignerCert", "TeeWorkerInfo", "UserBrief", "VerdictRecord",
               # the runtime's (the rest of chain/, node/consensus, vrf)
               "AssetDetails", "AssetMetadata", "Bill", "CacherInfo",
               "Exposure", "OssInfo", "SignedExtrinsic", "SlotClaim",
               "Vote", "VrfProof",
               # the node's (network, finality): imported here, since any
               # test file of the worker may import them first
               "Block", "Header", "Justification"]


@dataclasses.dataclass(frozen=True)
class _PairPoint:
    x: int
    y: bytes


jcodec.register(_PairPoint)
pcodec.register(_PairPoint)

CASES = [
    None, True, False, 0, 1, -1, 2**200, -(2**200),
    b"", b"\x00\xff" * 10, "", "héllo", ("a", 1), [1, [2, [3]]],
    {"b": 2, "a": 1}, frozenset({3, 1, 2}), np.arange(24, dtype=np.uint32)
    .reshape(2, 3, 4), np.zeros((0,), np.int64),
    _PairPoint(5, b"q"), (None, _PairPoint(-1, b""), {"k": (1, 2)}),
]


def field_value(rng, i):
    """A deterministic value of the kind chain types hold."""
    kind = i % 5
    if kind == 0:
        return int(rng.integers(-2**40, 2**40))
    if kind == 1:
        return rng.bytes(int(rng.integers(0, 40)))
    if kind == 2:
        return f"field-{i}"
    if kind == 3:
        return (int(rng.integers(0, 9)), rng.bytes(3), ("nested", True))
    return rng.integers(0, 2**32, (int(rng.integers(1, 6)),), dtype=np.uint32)


def instance(registry, name, seed):
    cls = registry[name]
    rng = np.random.default_rng(seed)
    return cls(*[field_value(rng, i)
                 for i in range(len(dataclasses.fields(cls)))])


def test_slice_types_are_registered_under_the_references_names():
    assert set(pcodec._REGISTRY) == set(SLICE_TYPES) | {"_PairPoint"}
    for name in SLICE_TYPES:
        assert [f.name for f in dataclasses.fields(pcodec._REGISTRY[name])] \
            == [f.name for f in dataclasses.fields(jcodec._REGISTRY[name])]


@pytest.mark.parametrize("name", SLICE_TYPES)
def test_type_bytes_equal_and_decode_across_packages(name):
    for seed in range(3):
        p, j = (instance(pcodec._REGISTRY, name, seed),
                instance(jcodec._REGISTRY, name, seed))
        blob = pcodec.encode(p)
        assert blob == jcodec.encode(j)
        back_j, back_p = jcodec.decode(blob), pcodec.decode(jcodec.encode(j))
        assert type(back_j) is jcodec._REGISTRY[name]
        assert type(back_p) is pcodec._REGISTRY[name]
        assert jcodec.encode(back_j) == blob == pcodec.encode(back_p)
        for f in dataclasses.fields(back_j):
            a, b = getattr(back_j, f.name), getattr(p, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("obj", CASES, ids=lambda o: type(o).__name__)
def test_value_bytes_equal(obj):
    blob = pcodec.encode(obj)
    assert blob == jcodec.encode(obj)
    assert pcodec.encode(pcodec.decode(blob)) == blob


def test_dict_and_set_encodings_are_canonical():
    assert pcodec.encode({"a": 1, "b": 2}) == pcodec.encode({"b": 2, "a": 1})
    assert pcodec.encode(frozenset({1, 2})) == pcodec.encode({2, 1})


def _deep(n):
    deep = ()
    for _ in range(n):
        deep = (deep,)
    return deep


MALFORMED = {
    "trailing": jcodec.encode(1) + b"\x00",
    "unknown-tag": b"\xfe",
    "empty": b"",
    "truncated-varint": bytes([3, 0x80]),
    "truncated-bytes": bytes([4, 5]) + b"ab",
    "truncated-tuple": bytes([6, 3, 3, 2]),
    "nesting": bytes([6, 1]) * 2000 + bytes([0]),
    "unknown-name": bytes([10, 3]) + b"Zzz" + bytes([0]),
    "field-count": bytes([10, 10]) + b"_PairPoint" + bytes([1, 3, 2]),
    "bad-dtype": bytes([11, 2]) + b"?!" + bytes([1, 1, 1, 0]),
    "shape-mismatch": bytes([11, 3]) + b"<u4" + bytes([1, 2, 4]) + b"\0" * 4,
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_input_fails_as_in_the_reference(case):
    blob = MALFORMED[case]
    with pytest.raises(jcodec.CodecError) as want:
        jcodec.decode(blob)
    with pytest.raises(pcodec.CodecError) as got:
        pcodec.decode(blob)
    assert str(got.value) == str(want.value)


def test_depth_cap_and_unregistered_on_encode():
    with pytest.raises(pcodec.CodecError, match="nesting"):
        pcodec.encode(_deep(pcodec.MAX_DEPTH + 2))
    assert pcodec.MAX_DEPTH == jcodec.MAX_DEPTH

    @dataclasses.dataclass(frozen=True)
    class _Unreg:
        v: int

    with pytest.raises(pcodec.CodecError, match="unregistered"):
        pcodec.encode(_Unreg(1))
    with pytest.raises(ValueError, match="collision"):
        pcodec.register(type("Proof", (), {}))
    ok = {"a": (1, [2, {"b": (3,)}])}
    assert pcodec.decode(jcodec.encode(ok)) == ok
