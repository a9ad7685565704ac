"""The reference's cesslint tests (``tests/test_lint.py``) on the port's
``cess_tpu_torch.analysis`` as written (``torch_node_port``: the file's
text with ``cess_tpu`` read as ``cess_tpu_torch``, its real-tree tests
pointed at ``cess_tpu_torch/`` and the port's empty baseline
``cess_tpu_torch/analysis/cesslint_baseline.json``, and its CLI runs made
with ``python -m cess_tpu_torch.analysis``), collected by pytest from the
rewritten module. The tree tests include
``test_repo_is_clean_and_fast``: the port's cesslint over
``cess_tpu_torch/`` reports 0 findings with the empty baseline.

Then a ``sim-determinism`` case on the port's own ``sim/``. The parity
of the two packages' analyzers is in ``test_torch_lint_parity.py``.
"""
import os

import torch_node_port as tp

tp.port_module("test_lint")

from port_test_lint import *  # noqa: E402,F401,F403

REPO = os.path.dirname(tp.TESTS)


def _rules(result) -> list:
    return sorted((f.rule, f.line) for f in result.findings)


def test_wallclock_planted_in_the_port_sim_fires():
    """A ``time.time()`` planted in a copy of the port's ``sim/world.py``
    fires ``sim-wallclock`` at its line, a ``random.random()`` fires
    ``sim-entropy``; the real ``sim/`` package stays silent (no finding,
    no inline suppression), and so does the copy before the plant."""
    from cess_tpu_torch import analysis

    rel = "cess_tpu_torch/sim/world.py"
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    assert analysis.lint_source(src, rel).findings == []
    anchor = "    def run_round(self, max_slots: int = 16) -> int:\n"
    assert src.count(anchor) == 1
    plant = ("    def _stamp(self):\n"
             "        import random\n"
             "        import time\n"
             "        return time.time(), random.random()\n\n")
    planted = src.replace(anchor, plant + anchor)
    line = planted[:planted.index("time.time()")].count("\n") + 1
    assert _rules(analysis.lint_source(planted, rel)) == [
        ("sim-entropy", line), ("sim-wallclock", line)]
    real = analysis.lint_paths([os.path.join(REPO, "cess_tpu_torch", "sim")],
                               root=REPO)
    assert real.files == 5 and real.errors == []
    assert real.findings == [] and real.suppressed == []
