"""Multi-node clusters on one host (the port's copy of
``ray_tpu/cluster_utils.py``, ``Cluster`` :19).

Reference: ``python/ray/cluster_utils.py:135`` (``Cluster.add_node`` :202,
``remove_node`` :286) — the fixture for multi-node and failover tests
without real machines. The GCS and the node managers run in this
process, each with a server of its own on the port's wire; the workers
are real processes forked from the runtime's fork server, so tasks cross
process boundaries.

A node spills past its store's budget into ``spill_dir`` (a directory
of its own in the temp dir by default), which goes with the node. A node
with ``num_gpus=n`` owns cards ``0..n-1`` unless ``card_ids`` names
others: two nodes on one host own disjoint cards, and each node's
cards are out of this process's card book for as long as it lives.
:meth:`Cluster.shutdown` stops every node (its worker processes killed
and reaped) and the GCS, and closes this process's connections, so no
process or runtime thread of the cluster outlives it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.gcs.server import GcsServer
from ray_tpu_torch._private.node_manager.server import NodeManager


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None,
                 gcs_persist_path: Optional[str] = None):
        self.gcs_persist_path = gcs_persist_path
        self.gcs = GcsServer(port=0, persist_path=gcs_persist_path)
        self.address = f"127.0.0.1:{self.gcs.port}"
        self.nodes: List[NodeManager] = []
        self.head_node: Optional[NodeManager] = None
        if initialize_head:
            self.head_node = self.add_node(**(head_node_args or {}))

    def restart_gcs(self) -> None:
        """Stop the GCS and start another on the same port, recovering
        from its persistence (fault-tolerance tests: reference
        ``python/ray/tests/test_gcs_fault_tolerance.py``)."""
        port = self.gcs.port
        self.gcs.shutdown()
        self.gcs = GcsServer(port=port, persist_path=self.gcs_persist_path)

    def add_node(self, num_cpus: float = 4, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 card_ids: Optional[List[int]] = None,
                 spill_dir: Optional[str] = None) -> NodeManager:
        res = {"CPU": float(num_cpus)}
        if num_gpus:
            res["GPU"] = float(num_gpus)
        res.update(resources or {})
        node = NodeManager(self.address, resources=res, labels=labels,
                           card_ids=card_ids, spill_dir=spill_dir)
        self.nodes.append(node)
        return node

    def remove_node(self, node: NodeManager, allow_graceful: bool = True):
        node.shutdown(graceful=allow_graceful)
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, timeout_s: float = 30.0) -> None:
        want = len(self.nodes)
        gcs = rpc.get_stub("GcsService", self.address)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            alive = [n for n in gcs.GetNodes(pb.GetNodesRequest()).nodes
                     if n.alive]
            if len(alive) >= want:
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster did not reach {want} alive nodes")

    def shutdown(self):
        for node in list(self.nodes):
            self.remove_node(node)
        self.gcs.shutdown()
        rpc.close_all_connections()
