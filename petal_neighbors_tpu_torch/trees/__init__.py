"""Index layer: the flat exact index, the ball tree, the vantage-point
tree and the mutable index."""

from .ball import BallTree, Node, NodeTable
from .bruteforce import BruteForce
from .dynamic import DynamicIndex
from .vantage import VantagePointTree

__all__ = ["BallTree", "Node", "NodeTable", "BruteForce", "DynamicIndex",
           "VantagePointTree"]
