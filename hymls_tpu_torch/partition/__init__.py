from .cartesian import CartesianPartitioner, PartitionParams
from .hierarchical import Hierarchy, SepGroup, build_hierarchy

__all__ = ["CartesianPartitioner", "PartitionParams", "Hierarchy",
           "SepGroup", "build_hierarchy"]
