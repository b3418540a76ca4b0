"""Index layer: the flat exact index and the ball tree."""

from .ball import BallTree, Node, NodeTable
from .bruteforce import BruteForce

__all__ = ["BallTree", "Node", "NodeTable", "BruteForce"]
