"""Hierarchical ordering: group dedup, linking, and level spawning.

Behavioral equivalent of the reference's HierarchicalMap
(reference src/HYMLS_HierarchicalMap.cpp): the partitioner produces all
*candidate* nodes per subdomain; here they are filtered against the
level's active node set, separator groups shared between subdomains are
deduplicated by their first GID, and groups with equal type tags are
linked (eliminated together, e.g. u/v/w on one face —
HYMLS_HierarchicalMap.cpp:120-142).

Everything here is host-side numpy; the output is consumed by
core/plan.py to build static device index plans.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class SepGroup:
    """A separator group: an ordered set of node GIDs eliminated by one
    orthogonal transform.  nodes[0] is the Vsum node."""

    nodes: np.ndarray
    type: int = -1


@dataclass
class SubdomainGroups:
    interior: np.ndarray
    separators: List[SepGroup]


@dataclass
class Hierarchy:
    """Filtered, deduplicated ordering for one level.

    Attributes:
      interior: per-subdomain interior GID arrays.
      sd_groups: per-subdomain list of indices into `groups`.
      groups: unique separator groups (global GID arrays, Vsum first).
      group_owner: for each unique group, the subdomain of first
        appearance ("local separator" owner in the serial setting).
      linked_sets: per owning subdomain, lists of unique-group indices
        eliminated together (the non-Vsum dense blocks).
    """

    interior: List[np.ndarray]
    sd_groups: List[List[int]]
    groups: List[SepGroup]
    group_owner: List[int]
    linked_sets: List[List[int]]

    @property
    def num_subdomains(self) -> int:
        return len(self.interior)

    def sep_nodes_of_sd(self, sd: int) -> np.ndarray:
        """Concatenated group nodes in group order — the row/col order of
        the per-subdomain Schur blocks (reference
        HierarchicalMap::SpawnMap Separators)."""
        gs = [self.groups[gi].nodes for gi in self.sd_groups[sd]]
        if not gs:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(gs)

    def all_interior_nodes(self) -> np.ndarray:
        if not self.interior:
            return np.empty(0, dtype=np.int64)
        return np.concatenate([a for a in self.interior])

    def all_separator_nodes(self) -> np.ndarray:
        if not self.groups:
            return np.empty(0, dtype=np.int64)
        return np.concatenate([g.nodes for g in self.groups])

    def vsum_nodes(self) -> np.ndarray:
        """One Vsum (first node) per unique group, in group order."""
        return np.array([g.nodes[0] for g in self.groups], dtype=np.int64)


def build_hierarchy(subdomains: Sequence[SubdomainGroups],
                    active: Optional[np.ndarray] = None) -> Hierarchy:
    """Filter candidate groups by the active node set and deduplicate.

    `active`: sorted array of active GIDs at this level (None = all
    candidates are active, i.e. the finest level)."""

    def filt(arr: np.ndarray) -> np.ndarray:
        if active is None or arr.size == 0:
            return arr
        pos = np.searchsorted(active, arr)
        pos = np.clip(pos, 0, active.size - 1)
        return arr[active[pos] == arr]

    interior: List[np.ndarray] = []
    sd_groups: List[List[int]] = []
    groups: List[SepGroup] = []
    group_owner: List[int] = []
    key_to_idx: Dict[int, int] = {}

    for sd, sdg in enumerate(subdomains):
        interior.append(filt(sdg.interior))
        my: List[int] = []
        for grp in sdg.separators:
            nodes = filt(grp.nodes)
            if nodes.size == 0:
                continue
            key = int(nodes[0])
            gi = key_to_idx.get(key)
            if gi is None:
                gi = len(groups)
                key_to_idx[key] = gi
                groups.append(SepGroup(nodes=nodes, type=grp.type))
                group_owner.append(sd)
            my.append(gi)
        sd_groups.append(my)

    # Link unique groups per owning subdomain by equal type tag
    # (reference LinkSeparators; used for the non-Vsum block structure).
    linked_sets: List[List[int]] = []
    for sd in range(len(subdomains)):
        owned = [gi for gi in sd_groups[sd] if group_owner[gi] == sd]
        by_type: List[List[int]] = []
        for gi in owned:
            t = groups[gi].type
            placed = False
            if t >= 0:
                for s in by_type:
                    if groups[s[0]].type == t:
                        s.append(gi)
                        placed = True
                        break
            if not placed:
                by_type.append([gi])
        linked_sets.extend(by_type)

    return Hierarchy(interior=interior, sd_groups=sd_groups, groups=groups,
                     group_owner=group_owner, linked_sets=linked_sets)
