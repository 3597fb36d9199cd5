"""Hierarchical quota math.

Equivalent of the reference's pkg/cache/resource_node.go:27-179:
- subtree_quota: node quota + children's lendable capacity
- guaranteed_quota: subtree quota the node will not lend out
- available(): remaining capacity walking up the cohort chain, capped by
  borrowing limits
- add_usage/remove_usage: usage bubbling past guaranteed quota

Nodes implement the protocol: `.resource_node` (ResourceNode) and
`.parent_node()` (node or None).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.core.resources import FlavorResource


@dataclass
class ResourceQuota:
    nominal: int = 0
    borrowing_limit: Optional[int] = None
    lending_limit: Optional[int] = None


@dataclass
class ResourceNode:
    quotas: dict = field(default_factory=dict)        # FlavorResource -> ResourceQuota
    subtree_quota: dict = field(default_factory=dict)  # FlavorResource -> int
    usage: dict = field(default_factory=dict)          # FlavorResource -> int

    def clone(self) -> "ResourceNode":
        # quotas/subtree_quota are replaced wholesale on update; share them.
        return ResourceNode(quotas=self.quotas, subtree_quota=self.subtree_quota,
                            usage=dict(self.usage))

    def quota_for(self, fr: FlavorResource) -> ResourceQuota:
        return self.quotas.get(fr, _ZERO_QUOTA)

    def guaranteed_quota(self, fr: FlavorResource) -> int:
        q = self.quotas.get(fr)
        if q is not None and q.lending_limit is not None:
            return max(0, self.subtree_quota.get(fr, 0) - q.lending_limit)
        return 0

    def calculate_lendable(self) -> dict:
        """Aggregate subtree quota per resource name
        (reference: calculateLendable)."""
        lendable: dict = {}
        for fr, q in self.subtree_quota.items():
            lendable[fr.resource] = lendable.get(fr.resource, 0) + q
        return lendable


_ZERO_QUOTA = ResourceQuota()


def available(node, fr: FlavorResource, enforce_borrow_limit: bool = True) -> int:
    """Remaining capacity for `node`, walking the cohort chain; may be
    negative under overadmission (reference: resource_node.go:89-104)."""
    rn: ResourceNode = node.resource_node
    parent = node.parent_node()
    if parent is None:
        return rn.subtree_quota.get(fr, 0) - rn.usage.get(fr, 0)
    guaranteed = rn.guaranteed_quota(fr)
    local_available = max(0, guaranteed - rn.usage.get(fr, 0))
    parent_available = available(parent, fr, enforce_borrow_limit)
    q = rn.quotas.get(fr)
    if enforce_borrow_limit and q is not None and q.borrowing_limit is not None:
        stored_in_parent = rn.subtree_quota.get(fr, 0) - guaranteed
        used_in_parent = max(0, rn.usage.get(fr, 0) - guaranteed)
        with_max_from_parent = stored_in_parent - used_in_parent + q.borrowing_limit
        parent_available = min(with_max_from_parent, parent_available)
    return local_available + parent_available


def potential_available(node, fr: FlavorResource) -> int:
    """Max capacity available assuming zero usage, respecting borrowing
    limits (reference: resource_node.go:108-119)."""
    rn: ResourceNode = node.resource_node
    parent = node.parent_node()
    if parent is None:
        return rn.subtree_quota.get(fr, 0)
    avail = rn.guaranteed_quota(fr) + potential_available(parent, fr)
    q = rn.quotas.get(fr)
    if q is not None and q.borrowing_limit is not None:
        avail = min(rn.subtree_quota.get(fr, 0) + q.borrowing_limit, avail)
    return avail


def add_usage(node, fr: FlavorResource, val: int) -> None:
    rn: ResourceNode = node.resource_node
    local_available = max(0, rn.guaranteed_quota(fr) - rn.usage.get(fr, 0))
    rn.usage[fr] = rn.usage.get(fr, 0) + val
    parent = node.parent_node()
    if parent is not None and val > local_available:
        add_usage(parent, fr, val - local_available)


def remove_usage(node, fr: FlavorResource, val: int) -> None:
    rn: ResourceNode = node.resource_node
    stored_in_parent = rn.usage.get(fr, 0) - rn.guaranteed_quota(fr)
    rn.usage[fr] = rn.usage.get(fr, 0) - val
    parent = node.parent_node()
    if stored_in_parent <= 0 or parent is None:
        return
    remove_usage(parent, fr, min(val, stored_in_parent))
