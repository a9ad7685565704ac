"""The reference's simulated-network tests (``tests/test_sim.py``) on the
port's ``cess_tpu_torch.sim`` as written (``torch_node_port``: the
file's text with ``cess_tpu`` read as ``cess_tpu_torch``, and its
scenario runs given ``devices=["cpu"] * 8``, the 8 host devices the
JAX package's tests see), collected by pytest from the rewritten module:
the virtual clock and event queue, the topologies, the partition twin,
the invariant tripwires, the fault plan on the virtual clock and the
traced adversarial audit. The replays of the scenario library are in
``test_torch_sim_replay.py``, the 100-node library in
``test_torch_sim_library.py``; the ``slow`` test stays slow.
"""
import torch_node_port as tp
from torch_sim_twin import _one_thread  # noqa: F401 (autouse)

tp.port_module("test_sim")

from port_test_sim import *  # noqa: E402,F401,F403

del test_scenario_replays_bit_identical  # noqa: F821
del test_full_library_at_100_nodes  # noqa: F821
