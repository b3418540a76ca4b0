"""Index layer: the flat exact index, the ball tree, the vantage-point
tree, the mutable index, the dual-tree join and the mutual-reachability
MST."""

from .ball import BallTree, Node, NodeTable
from .boruvka import boruvka_mst, mutual_reachability_mst
from .bruteforce import BruteForce
from .dual import dual_tree_knn
from .dynamic import DynamicIndex
from .vantage import VantagePointTree

__all__ = ["BallTree", "Node", "NodeTable", "BruteForce", "DynamicIndex",
           "VantagePointTree", "boruvka_mst", "mutual_reachability_mst",
           "dual_tree_knn"]
