"""The reference's TCP tests (``tests/test_net.py``: gossip, a lossy link,
peer discovery, ten processes at bounded degree, warp sync, DHT authority
discovery, deploy by code hash) on the port's ``NodeService``, each as
written (``torch_node_port``): its worker processes import the port's
node, which loads no torch. A cluster of JAX-package and port processes:
``test_torch_net_mixed.py``.
"""
import pytest

import torch_node_port as tp

CASES = tp.reference_tests("test_net")


@pytest.mark.parametrize("name", CASES)
def test_reference_tcp_test_on_the_port(name, request):
    tp.run("test_net", name, request)
