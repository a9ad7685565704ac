"""What the benchmark takes from the program under test, the PyTorch and
CUDA port ``cess_tpu_torch``: the agents' timed entry point and the
objects its set-up builds. Nothing else in
``portbench`` outside ``drivers/`` imports the port, and the plain
reference (``reference/``) imports none of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Entries:
    """The timed entry points a window drives (``node/offchain``), each
    called as the agents call it, with the engine off."""
    upload_batch: object


def entries() -> Entries:
    from cess_tpu_torch.node import offchain

    return Entries(offchain.upload_batch)


def podr2_key(alpha: np.ndarray, prf_key: np.ndarray, device):
    """The port's PoDR2 key from the benchmark's key material."""
    import torch

    from cess_tpu_torch.ops import podr2

    return podr2.Podr2Key(torch.from_numpy(alpha.astype(np.int32)),
                          torch.from_numpy(prf_key.astype(np.int64))
                          ).to(device)


def agent_pipeline(config: dict, key, device):
    """The gateway's pipeline of a configuration."""
    from cess_tpu_torch.models.pipeline import PipelineConfig
    from cess_tpu_torch.node import offchain

    cfg = PipelineConfig(k=config["k"], m=config["m"],
                         segment_size=config["segment_size"],
                         strategy=config["strategy"],
                         sectors=config["sectors"])
    return offchain.AgentPipeline(cfg, podr2_key=key, device=device)
