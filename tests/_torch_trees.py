"""Seeded N-ary trees for the port's tests (no JAX): the bake map's and
the pyramid bake's checks at N = 2 and N = 3."""

import numpy as np

from volrend_torch.models.synthetic import build_tree


def tree_n(N: int, max_depth: int, D: int, seed: int):
    """An N-ary tree of depth ``max_depth``: cells refined where a fixed
    seeded random field of the cell centre is above a level, leaves with
    seeded payloads (D values)."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, 4)) * 7.0
    ph = rng.uniform(0, 2 * np.pi, size=4)
    kl = rng.normal(size=(3, D)) * 3.0

    def refine(c, size, depth):
        return np.sin(c @ k + ph).sum(-1) > -0.5

    def leaf(c, size):
        return np.cos(c @ kl)

    return build_tree(refine, leaf, max_depth, D, N=N)
