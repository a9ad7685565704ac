"""cess_tpu_torch.obs: the observability leaves the serving plane needs.

``prom`` holds the mergeable latency histogram behind the engine's and
the streaming ingest's ``cess_engine_*`` histogram families. The TPU
package's tracing, flight recorder, SLO and profile planes are not
ported yet.
"""
