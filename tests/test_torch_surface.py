"""The port's public surface against the TPU package's, module by module.

One case per module of ``cess_tpu/`` with a counterpart file in
``cess_tpu_torch/``. The rule: every call that binds on the reference
binds the same way on the port. So, compared with ``inspect`` on the
imported modules (re-exports count):

- each public name of the reference module exists in the port module;
  a class has each public attribute its package defines, a dataclass
  each field;
- each parameter of a reference function, method or constructor exists
  in the port with the same name and kind, at the same position where
  it can be passed positionally;
- each parameter the port adds has a default and comes after the
  reference's positional parameters, or is keyword-only;
- where both give a default, the defaults are equal.

A difference that is right by design stands in ``ALLOWED`` with its
reason; an entry whose difference is gone fails its module's case.

The last tests run the calls that the surface pins on both packages:
the reference's PoDR2 keywords, the pipeline's positional order and the
stream's profiler ranges.
"""
import dataclasses
import enum
import importlib
import inspect
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

REF_ROOT = pathlib.Path(__file__).resolve().parent.parent / "cess_tpu"
# reference modules with no port file by design: the two Pallas kernels
# (the port's are CUDA sources under cess_tpu_torch/csrc/) and a jax shim
NO_PORT = {"ops/rs_pallas.py", "ops/podr2_pallas.py", "parallel/compat.py"}
MODULES = sorted(str(p.relative_to(REF_ROOT)) for p in REF_ROOT.rglob("*.py")
                 if str(p.relative_to(REF_ROOT)) not in NO_PORT)


def _renamed(module, name, pairs, reason):
    return {(module, f"{name}({old}->{new})"): reason for old, new in pairs}


_DIM = "PyTorch's idiom: a reduction takes dim=, not axis="
_ON_CARD = ("the port runs on the card unless asked for the CPU: no "
            "backend means the card, which raises without one")
ALLOWED = {
    ("ops/rs.py", "TPUCodec"): "named after the device: TorchCodec",
    ("ops/regen.py", "TPUCodec"): "named after the device: TorchCodec",
    ("ops/rs.py", "nibble_tables"):
        "a TPU lowering helper (the gather path's nibble tables)",
    ("ops/rs.py", "Strategy"):
        "a TPU lowering helper: the strategy names' type alias",
    ("ops/rs_xor.py", "DEFAULT_TILE_LANES"): "Pallas column tiling",
    ("ops/rs_xor.py", "apply_schedule(tile_lanes)"): "Pallas column tiling",
    ("ops/rs_xor.py", "apply_schedule(force)"):
        "the Pallas/jnp lowering switch",
    ("ops/pfield.py", "pack_bytes(xp)"): "the numpy/jnp switch",
    ("ops/pfield.py", "unpack_bytes(xp)"): "the numpy/jnp switch",
    **_renamed("ops/pfield.py", "dotmod", [("axis", "dim")], _DIM),
    **_renamed("ops/pfield.py", "summod", [("axis", "dim")], _DIM),
    **_renamed("ops/pfield.py", "dot_u16_deferred", [("axis", "dim")], _DIM),
    **_renamed("ops/pfield.py", "psum_mod",
               [("x", "parts"), ("axis_name", "group")],
               "a named-axis jax collective becomes a process-group sum"),
    **_renamed("obs/trace.py", "Tracer",
               [("jax_annotations", "device_annotations")],
               "the port imports no jax"),
    ("parallel/mesh.py", "P"):
        "jax's PartitionSpec alias: the port's shards are index slices",
    ("parallel/multihost.py", "P"):
        "jax's PartitionSpec alias: the port's shards are index slices",
    ("ops/rs.py", "make_codec(backend)"): _ON_CARD,
    ("ops/audit_backend.py", "make_audit_backend(backend)"): _ON_CARD,
    ("serve/engine.py", "make_engine(rs_backend)"): _ON_CARD,
    ("serve/engine.py", "make_engine(audit_backend)"): _ON_CARD,
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
_EMPTY = inspect.Parameter.empty


def _module_name(package: str, rel: str) -> str:
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join([package, *parts])


def _in_package(obj, package: str) -> bool:
    return (getattr(obj, "__module__", None) or "").split(".")[0] == package


def _public(module, package: str) -> dict:
    """The module's public names: everything not underscored and not a
    module, except a class or function of another package bound under
    its own name (an import); one bound under another name is an alias
    the module defines (``Strategy = str``)."""
    out = {}
    for name, value in vars(module).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if (isinstance(value, type) or callable(value)) \
                and not _in_package(value, package) \
                and getattr(value, "__name__", name) == name:
            continue
        out[name] = value
    return out


def _same(a, b) -> bool:
    """Default values equal across packages: a dataclass instance by
    class name and fields, an enum member, class or function by name."""
    if a is b:
        return True
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return (dataclasses.is_dataclass(b) and not isinstance(b, type)
                and type(a).__name__ == type(b).__name__
                and all(_same(getattr(a, f.name), getattr(b, f.name, _EMPTY))
                        for f in dataclasses.fields(a)))
    if isinstance(a, enum.Enum):
        return isinstance(b, enum.Enum) and a.name == b.name
    if isinstance(a, (type, types.FunctionType)):
        return getattr(b, "__name__", None) == a.__name__
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(map(_same, a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() \
            and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _signature_differences(name: str, ref, port, out: dict) -> None:
    try:
        rsig = inspect.signature(ref)
    except (TypeError, ValueError):
        return                       # a builtin: nothing to bind against
    try:
        psig = inspect.signature(port)
    except (TypeError, ValueError):
        out[name] = "the port's has no signature"
        return
    rps, pps = list(rsig.parameters.values()), list(psig.parameters.values())
    rnames = {p.name for p in rps}
    pindex = {p.name: i for i, p in enumerate(pps)}
    renamed = set()
    for i, r in enumerate(rps):
        if r.name not in pindex:
            p = pps[i] if i < len(pps) else None
            if p is not None and p.name not in rnames and p.kind == r.kind:
                renamed.add(p.name)
                out[f"{name}({r.name}->{p.name})"] = "renamed"
            else:
                out[f"{name}({r.name})"] = "missing"
            continue
        j = pindex[r.name]
        p = pps[j]
        if p.kind != r.kind:
            out[f"{name}({r.name})"] = f"kind {r.kind.name} -> {p.kind.name}"
        elif r.kind in _POSITIONAL and j != i:
            out[f"{name}({r.name})"] = f"position {i} -> {j}"
        elif r.default is not _EMPTY and p.default is _EMPTY:
            out[f"{name}({r.name})"] = "the port drops the default"
        elif r.default is not _EMPTY and not _same(r.default, p.default):
            out[f"{name}({r.name})"] = \
                f"default {r.default!r} -> {p.default!r}"
    npos = sum(r.kind in _POSITIONAL for r in rps)
    for j, p in enumerate(pps):
        if p.name in rnames or p.name in renamed or p.kind in _VARIADIC:
            continue
        if p.default is _EMPTY:
            out[f"{name}({p.name})"] = "the port adds a required parameter"
        elif p.kind in _POSITIONAL and j < npos:
            out[f"{name}({p.name})"] = \
                "the port adds it among the reference's positional ones"


def _unwrap(value):
    return value.__func__ if isinstance(value, (staticmethod, classmethod)) \
        else value


def _class_differences(name: str, ref: type, port, out: dict) -> None:
    if not isinstance(port, type):
        out[name] = "the port's is not a class"
        return
    _signature_differences(name, ref, port, out)
    fields = set()
    if dataclasses.is_dataclass(ref):
        fields = {f.name for f in dataclasses.fields(ref)}
        theirs = {f.name for f in dataclasses.fields(port)} \
            if dataclasses.is_dataclass(port) else set()
        for field in sorted(fields - theirs):
            out[f"{name}.{field}"] = "missing field"
    for attr in dir(ref):
        if attr.startswith("_") or attr in fields:
            continue
        owner = next((c for c in ref.__mro__ if attr in vars(c)), None)
        if owner is None or not _in_package(owner, "cess_tpu"):
            continue                 # inherited from outside the package
        if not hasattr(port, attr):
            out[f"{name}.{attr}"] = "missing"
            continue
        rv = _unwrap(inspect.getattr_static(ref, attr))
        pv = _unwrap(inspect.getattr_static(port, attr))
        if isinstance(rv, types.FunctionType):
            if callable(pv):
                _signature_differences(f"{name}.{attr}", rv, pv, out)
            else:
                out[f"{name}.{attr}"] = "the port's is not callable"


def _compared_at_home(name: str, ref, port) -> bool:
    """A re-export of another module's object, which the port re-exports
    from that module's counterpart too: that module's case compares it."""
    home = getattr(ref, "__module__", None) or ""
    if not home.startswith("cess_tpu."):
        return False
    try:
        port_home = importlib.import_module(
            "cess_tpu_torch" + home[len("cess_tpu"):])
    except ImportError:
        return False
    return getattr(port_home, name, None) is port \
        and getattr(importlib.import_module(home), name, None) is ref


def surface_differences(rel: str) -> dict:
    """{name or name(parameter): what differs} for one module."""
    ref = importlib.import_module(_module_name("cess_tpu", rel))
    port = importlib.import_module(_module_name("cess_tpu_torch", rel))
    out = {}
    for name, value in sorted(_public(ref, "cess_tpu").items()):
        if not hasattr(port, name):
            out[name] = "missing"
            continue
        theirs = getattr(port, name)
        if ref.__name__ != getattr(value, "__module__", ref.__name__) \
                and _compared_at_home(name, value, theirs):
            continue
        if isinstance(value, type):
            _class_differences(name, value, theirs, out)
        elif callable(value):
            _signature_differences(name, value, theirs, out)
    return out


def test_modules_without_a_port_file_are_exactly_the_by_design_ones():
    port_root = REF_ROOT.parent / "cess_tpu_torch"
    missing = {rel for rel in map(str, (p.relative_to(REF_ROOT)
                                        for p in REF_ROOT.rglob("*.py")))
               if not (port_root / rel).exists()}
    assert missing == NO_PORT
    assert len(MODULES) == 111


@pytest.mark.parametrize("rel", MODULES)
def test_port_module_binds_every_reference_call(rel):
    found = surface_differences(rel)
    allowed = {key: why for (mod, key), why in ALLOWED.items() if mod == rel}
    faults = {k: v for k, v in found.items() if k not in allowed}
    stale = sorted(set(allowed) - set(found))
    assert not faults, f"{rel}: the port differs from the reference: {faults}"
    assert not stale, f"{rel}: allowlisted differences are gone: {stale}"


def test_every_allowlist_entry_names_a_compared_module_and_a_reason():
    for (rel, key), why in ALLOWED.items():
        assert rel in MODULES, rel
        assert why.strip(), (rel, key)


# -- the calls the surface pins, run on both packages ------------------------

FRAG_BYTES = 64 * 1024               # 128 blocks of 512 bytes


@pytest.fixture
def cpu():
    """The port runs on the CPU here; the card is asked for by name in
    the card's own tests."""
    return torch.device("cpu")


def _both_keys(seed):
    from cess_tpu.ops import podr2 as jpodr2
    from cess_tpu_torch.convert import podr2_key_from_arrays

    jk = jpodr2.Podr2Key.generate(seed)
    return jk, podr2_key_from_arrays(
        np.asarray(jk.alpha), np.asarray(jax.random.key_data(jk.prf_key)),
        device="cpu")


def test_reference_podr2_keywords_give_equal_results_on_both(cpu):
    """``seed_bytes=`` and ``fragment_ids=`` as the reference names them:
    the same challenge, coefficients, tags, proof and verdicts."""
    from cess_tpu.ops import podr2 as jpodr2
    from cess_tpu_torch.ops import podr2

    rng = np.random.default_rng(15)
    frags = rng.integers(0, 256, (3, FRAG_BYTES), dtype=np.uint8)
    ids = rng.integers(0, 2**32, (3, 2), dtype=np.uint32)
    jk, key = _both_keys(15)
    blocks = FRAG_BYTES // podr2.BLOCK_BYTES

    jidx, jnu = jpodr2.gen_challenge(seed_bytes=b"round-15", num_blocks=blocks)
    idx, nu = podr2.gen_challenge(seed_bytes=b"round-15", num_blocks=blocks,
                                  device=cpu)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(nu.numpy().astype(np.uint32),
                                  np.asarray(jnu))
    jr = jpodr2.aggregate_coeffs(seed_bytes=b"round-15", fragment_ids=ids)
    r = podr2.aggregate_coeffs(seed_bytes=b"round-15", fragment_ids=ids,
                               device=cpu)
    np.testing.assert_array_equal(r.numpy().astype(np.uint32), np.asarray(jr))

    jtags = jpodr2.tag_fragments(jk, fragment_ids=ids, fragments=frags)
    tags = podr2.tag_fragments(key, fragment_ids=ids,
                               fragments=torch.from_numpy(frags))
    np.testing.assert_array_equal(tags.numpy().astype(np.uint32),
                                  np.asarray(jtags))

    mu, sigma = podr2.prove_aggregate(torch.from_numpy(frags), tags, idx, nu, r)
    jmu, jsigma = jpodr2.prove_aggregate(frags, jtags, jidx, jnu, jr)
    np.testing.assert_array_equal(mu.numpy().astype(np.uint32),
                                  np.asarray(jmu))
    for forged in (False, True):
        s = sigma.clone()
        js = np.asarray(jsigma).copy()
        if forged:
            s[0] = (s[0] + 1) % podr2.pf.P
            js[0] = (js[0] + 1) % jpodr2.pf.P
        got = podr2.verify_aggregate(key, fragment_ids=ids, num_blocks=blocks,
                                     idx=idx, nu=nu, r=r, mu=mu, sigma=s)
        want = jpodr2.verify_aggregate(jk, fragment_ids=ids,
                                       num_blocks=blocks, idx=jidx, nu=jnu,
                                       r=jr, mu=jmu, sigma=js)
        assert bool(got) == bool(want) == (not forged)

    mu_f, sigma_f = podr2.prove_batch(torch.from_numpy(frags), tags, idx, nu)
    jmu_f, jsigma_f = jpodr2.prove_batch(frags, jtags, jidx, jnu)
    sigma_f[1, 0] = (sigma_f[1, 0] + 1) % podr2.pf.P
    jsigma_f = np.asarray(jsigma_f).copy()
    jsigma_f[1, 0] = (jsigma_f[1, 0] + 1) % jpodr2.pf.P
    got = podr2.verify_batch(key, fragment_ids=ids, num_blocks=blocks,
                             idx=idx, nu=nu, mu=mu_f, sigma=sigma_f)
    want = jpodr2.verify_batch(jk, fragment_ids=ids, num_blocks=blocks,
                               idx=jidx, nu=jnu, mu=jmu_f, sigma=jsigma_f)
    assert got.tolist() == np.asarray(want).tolist() == [True, False, True]


def test_pipeline_binds_config_key_engine_positionally_on_both(cpu):
    """``StoragePipeline(cfg, key, engine)`` gives the engine the engine
    slot on both packages, and both encode and tag the same bytes."""
    from cess_tpu import serve as jserve
    from cess_tpu.models import pipeline as jpipeline
    from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
    from cess_tpu_torch.serve import make_engine

    for cls in (jpipeline.StoragePipeline, StoragePipeline):
        bound = inspect.signature(cls).bind("cfg", "key", "engine")
        assert dict(bound.arguments) == {"config": "cfg", "podr2_key": "key",
                                         "engine": "engine"}
    jk, key = _both_keys(16)
    jeng = jserve.make_engine(2, 1, podr2_key=jk)
    eng = make_engine(2, 1, rs_backend="cpu", audit_backend="cpu",
                      podr2_key=key)
    try:
        jpipe = jpipeline.StoragePipeline(
            jpipeline.PipelineConfig(k=2, m=1, segment_size=FRAG_BYTES * 2),
            jk, jeng)
        pipe = StoragePipeline(PipelineConfig(k=2, m=1,
                                              segment_size=FRAG_BYTES * 2),
                               key, eng, device=cpu)
        assert jpipe.engine is jeng and pipe.engine is eng
        seg = np.random.default_rng(16).integers(
            0, 256, (2, FRAG_BYTES * 2), dtype=np.uint8)
        jfr = jpipe.encode_step(seg)
        fr = pipe.encode_step(torch.from_numpy(seg))
        np.testing.assert_array_equal(fr.numpy(), np.asarray(jfr))
        ids = np.arange(6, dtype=np.uint32).reshape(2, 3)
        np.testing.assert_array_equal(
            pipe.tag_step(fr, ids).numpy().astype(np.uint32),
            np.asarray(jpipe.tag_step(jfr, ids)))
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("armed", [True, False])
def test_stream_opens_one_profiler_range_per_batch(cpu, armed):
    """Under ``Tracer(device_annotations=True)`` each streamed batch's
    dispatch opens one ``cess_stream#<n>`` range in a ``torch.profiler``
    trace, as the reference's opens one step annotation; disarmed, none."""
    from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
    from cess_tpu_torch.obs import trace
    from cess_tpu_torch.serve.stream import StreamingIngest

    pipe = StoragePipeline(PipelineConfig(k=2, m=1, segment_size=8192),
                           device=cpu)
    segs = np.random.default_rng(17).integers(0, 256, (7, 8192), np.uint8)
    stream = StreamingIngest(pipe, 3)
    with trace.armed(trace.Tracer(device_annotations=armed)), \
            torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = stream.ingest(segs)
    assert torch.equal(out["fragments"],
                       pipe.forward(torch.from_numpy(segs))["fragments"])
    names = sorted(e.name for e in prof.events()
                   if e.name.startswith("cess_stream"))
    assert stream.stats.batches == 3
    assert names == (["cess_stream#0", "cess_stream#1", "cess_stream#2"]
                     if armed else [])
