"""The split rule shared by the kernels' launch plans (K1's `splitPlan`,
K1b's `groupedSplitPlan`, K3's `attentionPlan`)."""


def splitsFor(baseBlocks: int, tiles: int, target: int):
    """(splits, tiles per split): `tiles` work tiles cut into splits of
    equal whole-tile size, the smallest size that needs no more than the
    `ceil(target / baseBlocks)` splits that would bring the grid to `target`
    blocks (one tile each where there are fewer tiles than that). Rounding
    to equal sizes may leave fewer splits than asked; none is empty."""
    want = max(1, min(tiles, -(-target // baseBlocks)))
    perSplit = -(-tiles // want)
    return -(-tiles // perSplit), perSplit
