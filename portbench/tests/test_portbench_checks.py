"""The correctness check shown to fail, on the CPU: each cell's control
(``portbench/controls.py``, the reference in the program's place with
one guarantee broken) and each fault the cell can have, planted under
the timed path, must come out not correct; the port as it is, correct.

The faults: a step that returns its state unchanged; half of the batch
left out; an answer altered where it is produced. (Every cell runs on
one card, so no exchange between cards can be left out.)

    python -m pytest -q portbench/tests
"""
import numpy as np
import pytest

from cess_tpu_torch.node import offchain
from portbench import controls, harness
from portbench.tests.test_portbench_harness import CELLS, cell_of, tiny

SEED = 2 ** 31 + 901


def run(name, entries=None):
    cell = tiny(cell_of(name))
    return harness.run_cell(cell, SEED, 0.6, False, "cpu", entries)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    r = run(name, controls.entries())
    assert r["attempted"] > 0
    assert not r["correct"], r["compared"]


# -- faults planted under the timed path -------------------------------------
def _upload_fault(kind):
    encode_step = offchain.AgentPipeline.encode_step
    tag_step = offchain.AgentPipeline.tag_step

    def encode(self, segments, tenant=None):
        handle = encode_step(self, segments, tenant)
        t = handle.tensor
        k = self.config.k
        if kind == "unchanged":          # the segments' rows, no parity
            t[:, k:] = 0
        elif kind == "half":             # the second half of the batch left
            t[(t.shape[0] + 1) // 2:] = 0
        else:                            # one byte altered
            t[0, -1, 7] ^= 1
        return handle

    def tag(self, fragments, fragment_ids=None, tenant=None):
        tags = tag_step(self, fragments, fragment_ids, tenant)
        if kind == "half":
            tags[(tags.shape[0] + 1) // 2:] = 0
        return tags

    return {"encode_step": encode, "tag_step": tag}


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, kind, monkeypatch):
    for attr, fn in _upload_fault(kind).items():
        monkeypatch.setattr(offchain.AgentPipeline, attr, fn)
    r = run(name)
    assert r["attempted"] > 0
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_port_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0, r["compared"]


def test_controls_break_only_their_guarantee():
    # the float64 sums are exact below 2^53 and wrong above it
    g = np.random.default_rng(4)
    small = g.integers(0, 1 << 8, (50, 16))
    w = g.integers(0, controls.P, (16, 2))
    exact = np.array([[sum(int(a) * int(b) for a, b in zip(row, w[:, j]))
                       % controls.P for j in range(2)] for row in small])
    assert np.array_equal(controls._float_dot(small, w), exact)
    big = g.integers(0, 1 << 16, (50, 256))
    w = g.integers(0, controls.P, (256, 2))
    exact = np.array([[sum(int(a) * int(b) for a, b in zip(row, w[:, j]))
                       % controls.P for j in range(2)] for row in big])
    assert (controls._float_dot(big, w) != exact).any()
