"""Helpers the training modules share: maps over the flow's parameter
structure (nested tuples, lists and dicts with tensor leaves, in a fixed
order), and generators seeded from a seed and a stream name."""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to every leaf; tuples, lists and dicts
    keep their type and order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in the order ``tree_map`` visits them."""
    out: List = []
    tree_map(out.append, tree)
    return out


def generator(device, seed: int, *stream: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and the integers
    ``stream``: distinct streams of one seed do not overlap, and a resumed
    run passes its start step to draw a fresh stream."""
    state = np.random.SeedSequence([int(seed), *map(int, stream)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))
