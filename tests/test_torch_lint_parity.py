"""The two packages' cesslint on the same sources give the same findings.

Each package's ``lint_paths`` runs over ``cess_tpu/`` and over
``cess_tpu_torch/``; the active findings, the inline-suppressed ones and
the stale suppressions, as JSON, and the SARIF report of each must be
equal across the packages. Both trees are clean, so the same holds on
dirt: every DIRTY fixture of the reference's ``tests/test_lint.py``,
linted at each package directory a rule family covers, gives equal
findings and SARIF reports.
"""
import os
import textwrap

import pytest

import torch_node_port as tp

REPO = os.path.dirname(tp.TESTS)
PKGS = ("cess_tpu", "cess_tpu_torch")
DIRS = ("ops", "serve", "node", "chain", "sim", "obs", "resilience")


def _analysis(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.analysis")


def _view(pkg, result) -> dict:
    a = _analysis(pkg)
    return {
        "findings": [f.to_json() for f in result.findings],
        "suppressed": [f.to_json() for f in result.suppressed],
        "stale": [list(map(str, s)) for s in result.stale_suppressions],
        "files": result.files,
        "errors": result.errors,
        "sarif": a.sarif_report(result.findings, a.all_rules()),
        "sarif_suppressed": a.sarif_report(result.suppressed, a.all_rules()),
    }


@pytest.mark.parametrize("tree", PKGS)
def test_both_analyzers_agree_on_the_tree(tree):
    views = [_view(pkg, _analysis(pkg).lint_paths(
        [os.path.join(REPO, tree)], root=REPO)) for pkg in PKGS]
    assert views[0] == views[1]
    assert views[0]["findings"] == [] and views[0]["errors"] == []
    assert views[0]["stale"] == [] and views[0]["suppressed"]


def test_both_analyzers_agree_on_every_dirty_fixture():
    import test_lint as ref

    assert sorted(_analysis(PKGS[0]).all_rules()) \
        == sorted(_analysis(PKGS[1]).all_rules())
    fixtures = {n: textwrap.dedent(v) for n, v in vars(ref).items()
                if n.startswith(("DIRTY_", "STALE_")) and isinstance(v, str)}
    assert len(fixtures) >= 10
    fired = 0
    for name, src in sorted(fixtures.items()):
        for d in DIRS:
            views = [_view(pkg, _analysis(pkg).lint_source(
                src, f"cess_tpu/{d}/fixture.py")) for pkg in PKGS]
            assert views[0] == views[1], (name, d)
            fired += len(views[0]["findings"])
    assert fired > 0
