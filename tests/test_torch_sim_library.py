"""The reference's 100-node library test
(``tests/test_sim.py::test_full_library_at_100_nodes``) on the port's
``cess_tpu_torch.sim`` as written, on 8 host devices: every scenario's
in-run and final invariants hold at 100 nodes and each world finalizes.
A file of its own: it is the longest test of the simulated network."""
import torch_node_port as tp
from torch_sim_twin import _one_thread, _yield_cpu  # noqa: F401 (autouse)

tp.port_module("test_sim")

from port_test_sim import test_full_library_at_100_nodes  # noqa: E402,F401
