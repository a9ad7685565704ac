"""The benchmark's own rules on the CPU: what ``portbench/run.py`` loads,
what the reference imports, the names and units of ``BENCHMARK.json``,
which cells report which metrics, and that a configuration, a traffic mix
and a metric added as new files are found by name.

    python -m pytest -q portbench/tests
"""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, run

PB = Path(harness.__file__).resolve().parent
ROOT = PB.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEG = 64 * 1024


def cell_of(name: str) -> harness.Cell:
    """A cell of ``BENCHMARK.json``."""
    return harness.load_cell(name)


CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cell: harness.Cell) -> harness.Cell:
    """``cell`` at a size the CPU runs in a second or two."""
    cell.config = dict(cell.config, segment_size=SEG)
    t = dict(cell.traffic)
    if t["kind"] == "upload":
        t.update(pool_bytes=4 << 20, check_bytes=2 << 20, check_share=0.5,
                 classes=[{"share": .5, "lo": 1000, "hi": SEG},
                          {"share": .4, "lo": SEG, "hi": 4 * SEG},
                          {"share": .1, "lo": 4 * SEG, "hi": 12 * SEG}])
    cell.traffic = t
    return cell


def imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute ones)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_in_any_benchmark_source():
    for path in PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        found = imports(path) & set(run.FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").glob("*.py"):
        assert imports(path) <= {"__future__", "hashlib", "numpy"}, path


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["cess_tpu_torch", "cess_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["cess_tpu.ops", "jax", "jaxlib.xla",
                                  "flax"]) == ["cess_tpu.ops", "flax", "jax",
                                               "jaxlib.xla"]


def test_a_run_loads_no_jax_module():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness, run, controls
from portbench.tests.test_portbench_harness import CELLS, cell_of, tiny
for name in CELLS:
    harness.run_cell(tiny(cell_of(name)), 5, 0.3, True, "cpu")
print(run.forbidden_modules())
print(sorted(m for m in sys.modules if m.startswith("portbench.metrics")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    found, readers = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert readers == str(sorted({
        "portbench.metrics." + harness.reader_path(m).stem.replace(".", "_")
        for m in [m["name"] for m in BENCH["per_layer"]]}))


def test_reference_loads_no_program_module():
    code = """
import sys
import portbench.reference.gf256, portbench.reference.podr2
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'torch', 'cess_tpu_torch', 'cess_tpu', 'jax'}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        file = json.loads((ROOT / c["file"]).read_text())
        assert file["reduced"] == c["reduced"] and file["name"] == c["name"]
        assert len(c["source"]) <= 200 and file["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
        kind = json.loads((PB / "traffic" / f"{w['traffic']}.json")
                          .read_text())["kind"]
        assert (PB / "drivers" / f"{kind}.py").exists()
    for m in BENCH["per_layer"]:
        assert harness.reader_path(m["name"]).parent == PB / "metrics"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_split_metric_is_read_by_its_quantitys_reader(tmp_path):
    assert harness.reader_path("device.idle_pct.upload") == \
        PB / "metrics" / "device.idle_pct.py"
    assert harness.reader_path("offchain.upload_fetch_pct") == \
        PB / "metrics" / "offchain.upload_fetch_pct.py"
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "device.idle_pct.repair.py").write_text(
        "def read(run):\n    return 1.0\n")
    assert harness.metric_reader("device.idle_pct.repair",
                                 (tmp_path, PB))(None) == 1.0
    with pytest.raises(FileNotFoundError):
        harness.reader_path("no_such.quantity.upload")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]

    def reports(cell, metric):
        m = e2e[metric]
        return "workloads" not in m or cell in m["workloads"]

    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(cell, m["moves"]), (m, cell)
    for cell in cells:
        assert reports(cell, "setup_s")
        assert any(reports(cell, n) for n in e2e if n != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_new_config_traffic_and_metric_found_by_name(tmp_path):
    for d in ("configs", "traffic", "metrics"):
        (tmp_path / d).mkdir()
    cfg = json.loads((PB / "configs" / "cess_rs21.json").read_text())
    cfg.update(name="cess_rs31", k=3, m=1, segment_size=3 * SEG)
    (tmp_path / "configs" / "cess_rs31.json").write_text(json.dumps(cfg))
    traffic = json.loads((PB / "traffic" / "upload.json").read_text())
    traffic.update(pool_bytes=4 << 20, check_bytes=1 << 20, classes=[
        {"share": 1.0, "lo": 1000, "hi": 6 * SEG}])
    (tmp_path / "traffic" / "upload_small.json").write_text(
        json.dumps(traffic))
    (tmp_path / "metrics" / "offchain.upload_segments.py").write_text(
        "def read(run):\n"
        "    return float(sum(r['segments'] for r in run.records))\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [{
        "name": "cess_rs31", "source": "test", "file":
        "configs/cess_rs31.json", "reduced": [], "why": "test"}]
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "rs31.upload_small", "config": "cess_rs31",
        "traffic": "upload_small", "chips": 1, "why": "test"}]
    bench["per_layer"] = BENCH["per_layer"] + [{
        "name": "offchain.upload_segments", "unit": "segments",
        "better": "higher", "source": "program_counter",
        "layer": "node/offchain", "moves": "upload_GiBps",
        "workloads": ["rs31.upload_small"]}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + [
        "rs31.upload_small"]) if m["name"] == "upload_GiBps" else m
        for m in BENCH["end_to_end"]]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = harness.load_cell("rs31.upload_small", path,
                             roots=(tmp_path, PB))
    assert cell.config["k"] == 3 and cell.traffic["pool_bytes"] == 4 << 20
    traced = harness.run_cell(cell, 11, 0.5, True, "cpu")
    assert traced["correct"]
    assert traced["metrics"]["offchain.upload_segments"]["value"] > 0
    plain = harness.run_cell(cell, 11, 0.5, False, "cpu")
    assert set(plain["metrics"]) == {"upload_GiBps", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    cell = tiny(cell_of(name))
    for trace in (False, True):
        r = harness.run_cell(cell, 2 ** 31 + 77, 0.5, trace, "cpu")
        assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r
        assert r["device"]["platform"] == "cpu"
    assert set(r["compared"]) and all(
        c["value"] == 0 for c in r["compared"].values())
    assert "offchain.upload_fetch_pct" in r["metrics"]


def test_same_seed_same_inputs():
    from portbench.drivers import upload

    cell = tiny(harness.load_cell("rs21.upload"))
    a = upload.files(cell.traffic, 2 ** 31 + 5)
    b = upload.files(cell.traffic, 2 ** 31 + 5)
    c = upload.files(cell.traffic, 2 ** 31 + 6)
    first = [next(a) for _ in range(40)]
    assert first == [next(b) for _ in range(40)]
    other = [next(c) for _ in range(40)]
    assert first != other
    deck = cell.traffic["deck_files"]
    assert sorted(s for s, _ in first[:deck]) == sorted(
        s for s, _ in other[:deck])
