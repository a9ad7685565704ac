"""The reference's replay test of every scenario
(``tests/test_sim.py::test_scenario_replays_bit_identical``) on the
port's ``cess_tpu_torch.sim`` as written, at 20 nodes on 8 host devices:
two same-seed runs give one witness, and each run shows the behaviour
its scenario exists for."""
import torch_node_port as tp
from torch_sim_twin import _one_thread, _yield_cpu  # noqa: F401 (autouse)

tp.port_module("test_sim")

from port_test_sim import test_scenario_replays_bit_identical  # noqa: E402,F401
