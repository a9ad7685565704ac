"""Kind ``upload_shared``: several gateway clients uploading at once
through one pipeline and its submission engine.

Traffic parameters (``traffic/<name>.json``): those of kind ``upload``
(``drivers/upload.py``), and

- ``clients``: the clients, each a thread in a closed loop: it starts
  its next upload as soon as its last one returned. Client ``i`` draws
  its own deck order and offsets from the seed and ``i`` and uploads as
  tenant ``gw<i>``; all of them slice one host pool.
- ``segment_bytes``: the segment size the byte sizes are written for. A
  configuration with another segment size has them scaled by its own
  over this one, so every file keeps its number of segments.

The configuration's ``engine.policy`` is the engine's admission policy.
Set-up is kind ``upload``'s (every segment count of the decks uploaded
once), then the gateway's pipeline gets the engine the TEE and gateway
drivers build, ``serve.make_engine(k, m, podr2_key=key, policy=...)``,
on the card with the backends' defaults, so the encode and the tags of
every upload go through its batches, and every bucket the clients can
form is warmed.

``step`` hands back the next upload that any client finished, with its
client, its stage clocks and ``engine_batches``: ``[class, batch id,
members, real rows, bucket rows]`` of each engine request that served
it. ``free`` stops the clients and joins each within ``JOIN_S``.

The check is kind ``upload``'s, over the kept uploads of every client,
plus ``uploads_off_engine``: kept uploads whose encode or tags no engine
batch served. It prints the window's batches to standard error: the
mean members and the pad share of each class.
"""
from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np

from portbench import data
from portbench.drivers import upload

JOIN_S = 120.0       # an upload in flight when the window ends finishes
CLIENT_STREAM = 5    # the seed stream a client's own seed comes from


def scaled(traffic: dict, segment_size: int) -> dict:
    """``traffic`` with its byte sizes scaled to ``segment_size``."""
    f = segment_size / traffic["segment_bytes"]
    if f == 1:
        return traffic
    return dict(traffic, pool_bytes=int(traffic["pool_bytes"] * f),
                check_bytes=int(traffic["check_bytes"] * f),
                classes=[dict(c, lo=max(1, int(c["lo"] * f)),
                              hi=int(c["hi"] * f))
                         for c in traffic["classes"]])


def client_seed(seed: int, client: int) -> int:
    """The seed of client ``client``'s files."""
    return int(data.rng(seed, CLIENT_STREAM, client).integers(0, 2 ** 62))


def engine_fields(up) -> list:
    """``[class, batch, members, rows, bucket]`` of each engine request
    that served ``up``; none for an upload with no engine receipts."""
    return [[rc.cls, rc.batch, rc.members, rc.rows, rc.bucket]
            for rc in getattr(up, "engine", ())]


class Driver(upload.Driver):
    def __init__(self, config, traffic, seed, device, entries=None):
        super().__init__(config, scaled(traffic, config["segment_size"]),
                         seed, device, entries)
        self._threads: list[threading.Thread] = []
        self._done: queue.Queue = queue.Queue()
        self._stop = threading.Event()

    def setup(self) -> None:
        import torch

        from cess_tpu_torch import serve
        from cess_tpu_torch.serve.buckets import bucket_rows

        if not hasattr(serve.SubmissionEngine, "receipts"):
            raise RuntimeError("the program's engine gives no per-request "
                               "receipts: this kind cannot tell which "
                               "uploads it served")
        # the key, the pipeline, the pool, every segment count uploaded
        super().setup()
        cfg, tr = self.cfg, self.tr
        k, m, seg = cfg["k"], cfg["m"], cfg["segment_size"]
        on_cpu = torch.device(self.device).type == "cpu"
        self.engine = serve.make_engine(
            k, m, podr2_key=self.pipe.podr2_key if cfg["engine"]["podr2"]
            else None,
            policy=serve.AdmissionPolicy(**cfg["engine"]["policy"]),
            **({"rs_backend": "cpu", "audit_backend": "cpu"} if on_cpu
               else {}))
        self.pipe.engine = self.engine
        # every bucket the clients' requests can fill: each client has at
        # most one upload, so one encode and one tag request, queued
        cap = self.engine.policy.max_batch_rows
        most = tr["clients"] * max(-(-s // seg) for s in
                                   upload.deck_sizes(tr))
        n = seg // k

        def buckets(most_rows):     # each with a pad row, as when shared
            top = bucket_rows(min(most_rows, cap))
            return [b // 2 + 1 for b in (2 ** i for i in range(
                top.bit_length())) if b <= top]

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.uint8, device=self.device)

        for rows in buckets(most):
            self.engine.encode(zeros(rows, k, n))
        for rows in buckets(most * (k + m)):
            self.engine.tag_fragments(np.zeros((rows, 2), np.uint32),
                                      zeros(rows, n))

    def _client(self, i: int) -> None:
        files = upload.files(self.tr, client_seed(self.seed, i))
        tenant = f"gw{i}"
        try:
            while not self._stop.is_set():
                size, off = next(files)
                t0 = time.perf_counter()
                try:
                    up = self.entries.upload_batch(
                        self.pipe, self.pool[off:off + size], tenant=tenant)
                    err = None
                except Exception as e:  # counted failed, the loop goes on
                    up, err = None, repr(e)
                t1 = time.perf_counter()
                self._done.put((i, size, off, t0, t1, up, err))
        except BaseException as e:      # the client itself broke: step raises
            self._done.put(e)
            raise

    def step(self) -> dict:
        if not self._threads:
            self._threads = [threading.Thread(
                target=self._client, args=(i,), daemon=True,
                name=f"portbench-client-{i}")
                for i in range(self.tr["clients"])]
            for t in self._threads:
                t.start()
        while True:
            try:
                got = self._done.get(timeout=1.0)
                break
            except queue.Empty:
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError("every upload client has stopped")
        if isinstance(got, BaseException):
            raise RuntimeError("an upload client failed") from got
        i, size, off, t0, t1, up, err = got
        rec = {"t0": t0, "t1": t1, "ok": up is not None, "size": size,
               "segments": -(-size // self.cfg["segment_size"]),
               "client": i}
        if up is None:
            rec["error"] = err
            return rec
        rec.update({f"{k}_s": v for k, v in up.seconds.items()})
        rec["engine_batches"] = engine_fields(up)
        keep = (size >= self.large and not self.large_kept) or \
            self.sample.random() < self.tr["check_share"]
        if keep and size <= self.budget:
            self.large_kept |= size >= self.large
            self.budget -= size
            rec["kept"] = len(self.kept)
            self.kept[rec["kept"]] = (off, size, up)
        return rec

    def free(self) -> None:
        self._stop.set()
        deadline = time.monotonic() + JOIN_S
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        alive = sum(t.is_alive() for t in self._threads)
        self.engine.close()
        self.pipe.engine = None
        del self.engine
        super().free()
        if alive:
            raise RuntimeError(f"{alive} upload clients still running "
                               f"{JOIN_S} s after the window")

    def check(self, records) -> dict:
        compared = super().check(records)
        kept = [self.kept[r["kept"]] for r in records if "kept" in r]
        compared["uploads_off_engine"] = (sum(
            not {"encode", "tag"} <= {f[0] for f in engine_fields(up)}
            for _, _, up in kept), 0)
        print("upload_shared: " + batch_summary(records), file=sys.stderr)
        return compared


def batch_summary(records) -> str:
    """The engine batches that served the window's uploads, each counted
    once: per class, how many, their mean members and pad share."""
    seen = {bid: (cls, members, rows, bucket) for r in records
            for cls, bid, members, rows, bucket in r.get("engine_batches",
                                                         ())}
    parts = []
    for cls in ("encode", "tag"):
        b = [v for v in seen.values() if v[0] == cls]
        if b:
            members = sum(v[1] for v in b) / len(b)
            pad = 100 * sum(v[3] - v[2] for v in b) / sum(v[3] for v in b)
            parts.append(f"{cls} {len(b)} batches, {members:.3f} members, "
                         f"pad {pad:.2f}%")
    return "; ".join(parts) or "no engine batches"
