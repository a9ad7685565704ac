"""Kind ``upload``: a gateway uploading files, one after another.

Traffic parameters (``traffic/<name>.json``):

- ``pool_bytes``: a host pool of seeded bytes; each file is a slice of
  it at an offset drawn from the seed.
- ``classes``: ``[{"share", "lo", "hi"}]``, file sizes uniform on [lo,
  hi) bytes in each class, in these shares.
- ``deck_files``: the files of one deck. A deck holds each class's share
  of it at sizes evenly spaced through the class (the midpoints of equal
  strata), so every deck, and every seed, has the same sizes; the seed
  shuffles each deck's order. Files come deck after deck.
- ``check_share``, ``check_bytes``: after the window, the plain reference
  judges the first file of the largest class to return and, drawn from
  the seed with probability ``check_share``, others, up to
  ``check_bytes`` of file bytes in all.

The operation is ``upload_batch`` of the agents (``node/offchain``) on
the gateway's pipeline: the file padded into segments, encoded, every
fragment hashed into its identity and id, and tagged.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import data, e2e, program
from portbench.reference import gf256, podr2 as ref_podr2, threefry



def deck_sizes(traffic: dict) -> list[int]:
    """One deck's file sizes, in class order."""
    sizes = []
    for c in traffic["classes"]:
        n = round(c["share"] * traffic["deck_files"])
        sizes += [int(c["lo"] + (i + 0.5) / n * (c["hi"] - c["lo"]))
                  for i in range(n)]
    return sizes


def files(traffic: dict, seed: int):
    """(size, offset) of each file, without end."""
    sizes = deck_sizes(traffic)
    order, offsets = data.rng(seed, data.ORDER), data.rng(seed, data.OFFSETS)
    while True:
        for i in order.permutation(len(sizes)):
            size = sizes[i]
            yield size, int(offsets.integers(0, traffic["pool_bytes"] - size
                                             + 1))


class Driver:
    def __init__(self, config, traffic, seed, device, entries=None):
        self.cfg, self.tr, self.seed = config, traffic, seed
        self.device = device
        self.entries = entries or program.entries()
        self.kept = {}

    def setup(self) -> None:
        cfg = self.cfg
        self.alpha, self.prf_key = data.key_material(
            self.seed, cfg["sectors"], cfg["limbs"])
        key = program.podr2_key(self.alpha, self.prf_key, self.device)
        self.pipe = program.agent_pipeline(cfg, key, self.device)
        self.pool = data.host_bytes(self.seed, 0, self.tr["pool_bytes"],
                                    self.device)
        seg = cfg["segment_size"]
        # every segment count the decks hold, once
        for segs in sorted({-(-s // seg) for s in deck_sizes(self.tr)}):
            self.entries.upload_batch(self.pipe, self.pool[:segs * seg - 1])
        self.files = files(self.tr, self.seed)
        self.sample = data.rng(self.seed, data.SAMPLE)
        self.budget = self.tr["check_bytes"]
        self.large = self.tr["classes"][-1]["lo"]
        self.large_kept = False

    def step(self) -> dict:
        size, off = next(self.files)
        t0 = time.perf_counter()
        try:
            up = self.entries.upload_batch(self.pipe,
                                           self.pool[off:off + size])
            ok, err = True, None
        except Exception as e:      # counted failed, the loop goes on
            up, ok, err = None, False, repr(e)
        t1 = time.perf_counter()
        rec = {"t0": t0, "t1": t1, "ok": ok, "size": size,
               "segments": -(-size // self.cfg["segment_size"])}
        if up is not None:
            rec.update({f"{k}_s": v for k, v in up.seconds.items()})
            keep = (size >= self.large and not self.large_kept) or \
                self.sample.random() < self.tr["check_share"]
            if keep and size <= self.budget:
                self.large_kept |= size >= self.large
                self.budget -= size
                rec["kept"] = len(self.kept)
                self.kept[rec["kept"]] = (off, size, up)
        else:
            rec["error"] = err
        return rec

    def end_to_end(self, records, window_s: float) -> dict:
        return {"upload_GiBps": e2e.rate([r for r in records if r["ok"]],
                                         "size", window_s, 2 ** 30)}

    def free(self) -> None:
        import torch

        del self.pipe
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, records) -> dict:
        """The kept files of the window against the plain reference:
        fragments byte for byte, every identity (fragment and segment
        hashes, the file hash, the ids), every tag word."""
        k, m, seg = self.cfg["k"], self.cfg["m"], self.cfg["segment_size"]
        wrong = {"fragment_bytes": 0, "identities": 0, "tag_words": 0}
        kept = [self.kept[r["kept"]] for r in records if "kept" in r]
        with ThreadPoolExecutor(data.WORKERS) as pool:
            for off, size, up in kept:
                buf = np.zeros(-(-size // seg) * seg, np.uint8)
                buf[:size] = self.pool[off:off + size]
                segs = buf.reshape(-1, seg)
                frags = list(pool.map(lambda s: gf256.encode(k, m, s), segs))
                got = np.asarray(up.fragments)
                if got.shape != (len(segs), k + m, seg // k):
                    wrong["fragment_bytes"] += buf.size * (k + m) // k
                    continue
                wrong["fragment_bytes"] += int(sum(
                    np.count_nonzero(f != g) for f, g in zip(frags, got)))
                rows = [r for f in frags for r in f]
                hashes = list(pool.map(data.digest, rows))
                seg_hashes = list(pool.map(data.digest, segs))
                ids = np.stack([threefry.fragment_id(h) for h in hashes])
                tags = list(pool.map(
                    lambda i: ref_podr2.tags(self.alpha, self.prf_key,
                                             ids[i], rows[i]),
                    range(len(rows))))
                got_tags = np.asarray(up.tags).reshape(len(rows), -1,
                                                       self.cfg["limbs"])
                wrong["tag_words"] += int(sum(
                    np.count_nonzero(t != g) for t, g in zip(tags, got_tags)))
                got_hashes = [h for fs in up.fragment_hashes for h in fs]
                wrong["identities"] += sum(
                    a != b for a, b in zip(hashes, got_hashes)) + sum(
                    a != b for a, b in zip(seg_hashes, up.segment_hashes)) \
                    + int(data.digest(b"".join(hashes)) != up.file_hash) \
                    + int(np.count_nonzero(
                        ids != np.asarray(up.ids).reshape(-1, 2)))
        compared = {k_: (v, 0) for k_, v in wrong.items()}
        compared["files_unchecked"] = (int(not kept), 0)
        return compared
