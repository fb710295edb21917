"""Cluster scheduling policies (the port's copy of
``ray_tpu/_private/scheduler/policies.py``, all of it: ``pick_node_hybrid``
:41, ``pick_node_spread`` :74, ``pick_node_affinity`` :86,
``match_labels`` :104, ``feasible_with_labels`` :135, ``place_bundles``
:144). They read the port's :class:`~ray_tpu_torch._private.messages.NodeInfo`;
the card's resource is ``"GPU"`` where JAX's is ``"TPU"``, and the slice
labels (``tpu-slice``, ``tpu-pod-type``) keep their names.

Reference: ``src/ray/raylet/scheduling/policy/`` (SURVEY.md C16) — hybrid
(pack-until-50%-then-spread, ``hybrid_scheduling_policy.cc:99,186``), spread,
node-affinity, and the bundle policies for placement groups
(``bundle_scheduling_policy.h``). TPU-native addition: nodes carry topology
labels (``tpu-slice``, ``tpu-pod-type``) and bundle PACK prefers keeping a
group inside one ICI-connected slice — the property that decides whether
collectives ride ICI or DCN.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch._private import messages as pb

HYBRID_THRESHOLD = 0.5  # reference: RAY_scheduler_spread_threshold default


def _fits(node: pb.NodeInfo, demand: Dict[str, float]) -> bool:
    return all(node.available.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())


def _feasible(node: pb.NodeInfo, demand: Dict[str, float]) -> bool:
    return all(node.resources.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())


def _utilization(node: pb.NodeInfo) -> float:
    """Critical-resource utilization in [0, 1]."""
    utils = []
    for k, total in node.resources.items():
        if total <= 0:
            continue
        utils.append(1.0 - node.available.get(k, 0.0) / total)
    return max(utils) if utils else 0.0


def pick_node_hybrid(
    nodes: Sequence[pb.NodeInfo],
    demand: Dict[str, float],
    local_node_id: Optional[str] = None,
    spread_threshold: float = HYBRID_THRESHOLD,
) -> Optional[str]:
    """Default policy: prefer packing onto low-index (local-first) nodes while
    their utilization stays under the threshold, then spread by lowest
    utilization (reference: hybrid_scheduling_policy.cc:99)."""
    alive = [n for n in nodes if n.alive and _fits(n, demand)]
    if not alive:
        return None
    # local-first ordering, then stable by node id for determinism
    alive.sort(key=lambda n: (n.node_id != local_node_id, n.node_id))
    below = [n for n in alive if _utilization(n) < spread_threshold]
    if below:
        return below[0].node_id
    return min(alive, key=_utilization).node_id


def util_after(node: pb.NodeInfo, demand: Dict[str, float]) -> float:
    """Critical-resource utilization AFTER charging ``demand`` — the
    quantity SPREAD placement must compare (pre-charge utilization lets an
    idle-but-small node swallow a whole fan-out serially)."""
    utils = []
    for k, total in node.resources.items():
        if total <= 0:
            continue
        used = total - node.available.get(k, 0.0) + demand.get(k, 0.0)
        utils.append(used / total)
    return max(utils) if utils else 0.0


def pick_node_spread(
    nodes: Sequence[pb.NodeInfo], demand: Dict[str, float]
) -> Optional[str]:
    alive = [n for n in nodes if n.alive and _fits(n, demand)]
    if not alive:
        return None
    # Rank by POST-charge utilization (what the node would look like with
    # this task on it): pre-charge ranking prefers idle-but-tiny nodes
    # that the demand would instantly saturate.
    return min(alive, key=lambda n: util_after(n, demand)).node_id


def pick_node_affinity(
    nodes: Sequence[pb.NodeInfo], demand: Dict[str, float],
    node_id: str, soft: bool,
) -> Optional[str]:
    for n in nodes:
        if n.node_id == node_id and n.alive and _fits(n, demand):
            return n.node_id
    if soft:
        return pick_node_hybrid(nodes, demand)
    return None


def feasible_anywhere(nodes: Sequence[pb.NodeInfo], demand: Dict[str, float]) -> bool:
    return any(_feasible(n, demand) for n in nodes if n.alive)


# ------------------------------------------------------------- node labels

def match_labels(labels: Dict[str, str], selector: Dict[str, dict]) -> bool:
    """Evaluate a hard/soft selector map against one node's labels.

    Value specs (see ``util/scheduling_strategies.py`` In/NotIn/Exists/
    DoesNotExist; reference: node_label_scheduling_policy.h semantics):
    ``{"in": [...]}`` requires presence + membership, ``{"not_in": [...]}``
    passes when absent or not a member, ``{"exists": b}`` checks presence.
    """
    for key, spec in selector.items():
        present = key in labels
        if "in" in spec:
            if not present or labels[key] not in spec["in"]:
                return False
        elif "not_in" in spec:
            if present and labels[key] in spec["not_in"]:
                return False
        elif "exists" in spec:
            if present != bool(spec["exists"]):
                return False
    return True


def parse_label_selector(raw: bytes) -> Optional[Dict[str, dict]]:
    """Decode TaskSpec.label_selector; None when unset."""
    if not raw:
        return None
    import json

    return json.loads(bytes(raw).decode())


def feasible_with_labels(nodes: Sequence[pb.NodeInfo], demand: Dict[str, float],
                         selector: Dict[str, dict]) -> bool:
    hard = selector.get("hard") or {}
    return any(_feasible(n, demand) for n in nodes
               if n.alive and match_labels(dict(n.labels), hard))


# ---------------------------------------------------------------- bundles

def place_bundles(
    info: pb.PlacementGroupInfo, nodes: Sequence[pb.NodeInfo],
    pending: Optional[Sequence] = None,
    occupied: Sequence[str] = (),
) -> Optional[List[str]]:
    """Assign each pending bundle a node id per strategy; None if infeasible
    now.

    PACK/STRICT_PACK prefer one node — and among multi-node fallbacks, nodes
    sharing one ``tpu-slice`` label (ICI-connected) are preferred over
    arbitrary nodes (TPU-topology-aware packing).

    ``pending``/``occupied`` support partial re-placement after a node death
    (reference: gcs_placement_group_manager.cc:585): only ``pending`` bundles
    are assigned; ``occupied`` lists nodes hosting the group's surviving
    bundles — STRICT_SPREAD avoids them, STRICT_PACK requires them.
    """
    bundles = list(pending) if pending is not None else list(info.bundles)
    strategy = info.strategy or "PACK"
    alive = [n for n in nodes if n.alive]
    if not alive:
        return None
    if occupied:
        if strategy == "STRICT_PACK":
            # Survivors fix the node: everything re-placed must join them.
            home = occupied[0]
            node = next((n for n in alive if n.node_id == home), None)
            if node is None or not _all_fit(bundles, [dict(node.available)]):
                return None
            return [home] * len(bundles)
        if strategy == "STRICT_SPREAD":
            alive = [n for n in alive if n.node_id not in set(occupied)]
            if not alive:
                return None

    def bundle_demand(b) -> Dict[str, float]:
        return dict(b.resources)

    if strategy in ("PACK", "STRICT_PACK"):
        # Try single node first.
        for n in sorted(alive, key=_utilization):
            avail = dict(n.available)
            if _all_fit(bundles, [avail]):
                return [n.node_id] * len(bundles)
        if strategy == "STRICT_PACK":
            return None
        # Greedy multi-node pack, grouping nodes by slice label first.
        groups = defaultdict(list)
        for n in alive:
            groups[n.labels.get("tpu-slice", n.node_id)].append(n)
        ordered = sorted(groups.values(), key=len, reverse=True)
        flat: List[pb.NodeInfo] = [n for grp in ordered for n in
                                   sorted(grp, key=_utilization)]
        return _greedy_pack(bundles, flat)

    if strategy in ("SPREAD", "STRICT_SPREAD"):
        assignment: List[str] = []
        used: Dict[str, Dict[str, float]] = {
            n.node_id: dict(n.available) for n in alive}
        node_order = sorted(alive, key=_utilization)
        taken: List[str] = []
        for b in bundles:
            demand = bundle_demand(b)
            placed = None
            for n in node_order:
                if strategy == "STRICT_SPREAD" and n.node_id in taken:
                    continue
                avail = used[n.node_id]
                if all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items()):
                    placed = n.node_id
                    break
            if placed is None:
                return None
            for k, v in demand.items():
                used[placed][k] = used[placed].get(k, 0.0) - v
            taken.append(placed)
            assignment.append(placed)
        return assignment

    raise ValueError(f"unknown placement strategy {strategy!r}")


def _all_fit(bundles, avails: List[Dict[str, float]]) -> bool:
    avail = dict(avails[0])
    for b in bundles:
        for k, v in b.resources.items():
            if avail.get(k, 0.0) + 1e-9 < v:
                return False
            avail[k] = avail.get(k, 0.0) - v
    return True


def _greedy_pack(bundles, nodes: List[pb.NodeInfo]) -> Optional[List[str]]:
    used = {n.node_id: dict(n.available) for n in nodes}
    assignment = []
    for b in bundles:
        placed = None
        for n in nodes:
            avail = used[n.node_id]
            if all(avail.get(k, 0.0) + 1e-9 >= v for k, v in b.resources.items()):
                placed = n.node_id
                break
        if placed is None:
            return None
        for k, v in b.resources.items():
            used[placed][k] = used[placed].get(k, 0.0) - v
        assignment.append(placed)
    return assignment
