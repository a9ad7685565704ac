"""The shared gateway card's cell on the CPU: kind ``upload_shared``
(four clients on one pipeline and its submission engine) through the
harness, its two readers on synthetic runs, and faults planted in the
engine and the program that its check must read as not correct.

    python -m pytest -q portbench/tests
"""
import dataclasses

import pytest

from cess_tpu_torch.serve import AdmissionPolicy
from cess_tpu_torch.serve.engine import SubmissionEngine
from portbench import harness
from portbench.drivers import upload_shared

CELL = "rs21_engine.upload4"
SEED = 2 ** 31 + 1234
SEG = 64 * 1024
WAIT, PAD = "serve.engine_wait_pct", "serve.engine_pad_pct"
HASH = "offchain.shared_hash_pct"


def tiny(**policy) -> harness.Cell:
    """The cell at a 64 KiB segment: its traffic scales with it."""
    cell = harness.load_cell(CELL)
    cell.config = dict(cell.config, segment_size=SEG)
    if policy:
        cell.config["engine"] = dict(cell.config["engine"], policy=dict(
            cell.config["engine"]["policy"], **policy))
    return cell


def test_configuration_states_the_ports_default_policy():
    cell = harness.load_cell(CELL)
    assert cell.config["engine"]["policy"] == dataclasses.asdict(
        AdmissionPolicy())
    assert cell.config["reduced"] == [] and cell.chips == 1
    t = upload_shared.scaled(cell.traffic, cell.config["segment_size"])
    assert t is cell.traffic            # published segment: nothing scaled


def test_traffic_keeps_segment_counts_at_a_small_segment():
    traffic = harness.load_cell(CELL).traffic
    small = upload_shared.scaled(traffic, SEG)
    f = traffic["segment_bytes"] // SEG
    assert small["pool_bytes"] * f == traffic["pool_bytes"]
    big = [-(-s // traffic["segment_bytes"])
           for s in upload_shared.upload.deck_sizes(traffic)]
    assert [-(-s // SEG) for s in upload_shared.upload.deck_sizes(small)] \
        == big


def test_clients_draw_their_own_files():
    traffic = upload_shared.scaled(harness.load_cell(CELL).traffic, SEG)
    firsts = [[next(f) for _ in range(20)] for f in (
        upload_shared.upload.files(traffic,
                                   upload_shared.client_seed(SEED, i))
        for i in range(4))]
    assert len({tuple(x) for x in firsts}) == 4
    again = upload_shared.upload.files(traffic,
                                       upload_shared.client_seed(SEED, 0))
    assert [next(again) for _ in range(20)] == firsts[0]


def test_cell_runs_correct_through_the_engine_on_the_cpu(capfd):
    cell = tiny()
    for trace in (False, True):
        r = harness.run_cell(cell, SEED, 0.6, trace, "cpu")
        assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r
        assert set(r["compared"]) == {
            "fragment_bytes", "identities", "tag_words", "files_unchecked",
            "uploads_off_engine"}
        assert all(c["value"] == 0 for c in r["compared"].values())
    # the device's readers find no trace on the CPU
    assert set(r["metrics"]) == {WAIT, PAD, HASH}
    for name in (WAIT, PAD, HASH):
        assert 0 <= r["metrics"][name]["value"] < 100
    assert "upload_shared: encode" in capfd.readouterr().err


def test_program_without_receipts_fails_at_setup(monkeypatch):
    monkeypatch.delattr(SubmissionEngine, "receipts")
    with pytest.raises(RuntimeError, match="receipts"):
        harness.run_cell(tiny(), SEED, 0.3, False, "cpu")


# -- the readers on synthetic runs -------------------------------------------
def rec(t0, t1, batches=None, profiled=False, ok=True, enc=0.0, tag=0.0,
        hashed=0.0):
    r = {"t0": t0, "t1": t1, "ok": ok, "profiled": profiled}
    if batches is not None:
        r.update({"encode.queue_s": enc, "tag.queue_s": tag,
                  "hash_s": hashed, "engine_batches": batches})
    return r


def run_of(records, kind="upload_shared"):
    return harness.Run(CELL, kind, {}, records)


def read(name, run):
    return harness.metric_reader(name)(run)


def test_wait_share_over_the_host_uploads():
    run = run_of([
        rec(0.0, 2.0, [], enc=0.25, tag=0.25),
        rec(1.0, 3.0, [], enc=0.5, tag=0.0),
        rec(0.0, 10.0, [], profiled=True, enc=9.0),     # in the slice
        rec(0.0, 1.0, [], ok=False, enc=1.0),           # failed
    ])
    assert read(WAIT, run) == pytest.approx(100.0 * 1.0 / 4.0)


def test_pad_share_counts_each_batch_once():
    shared_enc = ["encode", 7, 2, 5, 8]          # 5 real rows of 8
    shared_tag = ["tag", 8, 2, 15, 16]
    run = run_of([
        rec(0.0, 1.0, [shared_enc, shared_tag]),
        rec(0.0, 1.0, [shared_enc, shared_tag]),     # the same two batches
        rec(0.0, 1.0, [["encode", 9, 1, 4, 4], ["tag", 10, 1, 12, 16]]),
        rec(0.0, 1.0, [["encode", 11, 1, 64, 64]], profiled=True),
    ])
    # pad rows 3 + 1 + 0 + 4 over rows 8 + 16 + 4 + 16
    assert read(PAD, run) == pytest.approx(100.0 * 8 / 44)


def test_hash_share_over_the_host_uploads_of_shared_cells_only():
    records = [
        rec(0.0, 2.0, [], hashed=1.0),
        rec(1.0, 3.0, [], hashed=0.5),              # beside the first
        rec(0.0, 10.0, [], profiled=True, hashed=9.0),  # in the slice
        rec(0.0, 1.0, [], ok=False, hashed=1.0),        # failed
    ]
    assert read(HASH, run_of(records)) == pytest.approx(100.0 * 1.5 / 4.0)
    assert read(HASH, run_of(records, kind="upload")) is None


@pytest.mark.parametrize("name", [WAIT, PAD, HASH])
def test_readers_read_none_without_the_fields(name):
    assert read(name, run_of([rec(0.0, 1.0), rec(1.0, 2.0)])) is None
    assert read(name, run_of([])) is None
    assert read(name, run_of([rec(0.0, 1.0, [], profiled=True)])) is None


# -- faults planted under the timed path --------------------------------------
def swap_two_members(monkeypatch):
    """The engine's split hands the first two members of a batch each
    other's results (files of one size, so the shapes agree)."""
    split = SubmissionEngine._split_rows

    def swapped(self, batch, out, lane=None):
        results = split(self, batch, out, lane)
        if len(results) > 1 and results[0].shape == results[1].shape:
            results[0], results[1] = results[1], results[0]
        return results

    monkeypatch.setattr(SubmissionEngine, "_split_rows", swapped)


def one_size(cell):
    cell.traffic = dict(cell.traffic, classes=[
        {"share": 1.0, "lo": 3 * (16 << 20), "hi": 3 * (16 << 20) + 1}],
        check_share=1.0)
    return cell


def test_swapped_members_are_not_correct(monkeypatch):
    cell = one_size(tiny(max_delay=0.05))
    r = harness.run_cell(cell, SEED, 0.6, False, "cpu")
    assert r["correct"], r["compared"]          # sound while unplanted
    swap_two_members(monkeypatch)
    r = harness.run_cell(cell, SEED, 0.6, False, "cpu")
    assert r["attempted"] > 0
    assert not r["correct"], r["compared"]
    assert r["compared"]["fragment_bytes"]["value"] > 0


def test_upload_off_the_engine_is_not_correct(monkeypatch):
    """Uploads whose tags bypassed the engine (their receipts say so)
    are counted, though their bytes are right."""
    from cess_tpu_torch.node import offchain

    upload_batch = offchain.upload_batch

    def tags_direct(pipeline, data, **kw):
        up = upload_batch(pipeline, data, **kw)
        return dataclasses.replace(up, engine=tuple(
            rc for rc in up.engine if rc.cls != "tag"))

    monkeypatch.setattr(offchain, "upload_batch", tags_direct)
    r = harness.run_cell(tiny(), SEED, 0.6, False, "cpu")
    assert r["attempted"] > 0 and not r["correct"], r["compared"]
    assert r["compared"]["uploads_off_engine"]["value"] > 0
    assert r["compared"]["tag_words"]["value"] == 0
