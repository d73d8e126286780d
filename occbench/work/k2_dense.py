"""A frozen copy of the dense-grid count of one K2 call (the port's smoke
test's `k2_work` and `k2_bwd_work`), kept to document what it counts: every
site of the z-packed grid, active or not, times the extended weight's
nonzero blocks. That is what the present kernel computes, not what the
inputs need: a flagship forward's 13 calls count 1.976e12 FLOP this way.
No metric reads it; the rooflines count rulebook pairs (sparse.py)."""

KB = 16  # input lanes per K-block of the kernel


def kblocks(p: int, C: int, Co: int):
    """The kernel's K-blocks: (lane of x, pack offset, first output column,
    number of output columns), as the port's ops/subm_conv.py lists them."""
    out = []
    groups = [(z * C, 0, z) for z in range(p)] + [(0, 1, p),
                                                  ((p - 1) * C, -1, -1)]
    for lane0, dg, z in groups:
        lo, hi = max(0, z - 1), min(p - 1, z + 1)
        for q in range(0, C, KB):
            out.append((lane0 + q, dg, lo * Co, (hi - lo + 1) * Co))
    return out


def k2_work(shape, p, Co, mode, esz):
    """(FLOP, bytes) of one K2 call over the whole packed grid `shape`
    [B, bz, X, Y, p*C]; esz the activations' element size."""
    B, bz, X, Y, pC = shape
    C = pC // p
    ops = 0
    for _, dg, _, width in kblocks(p, C, Co):
        packs = B * (bz if dg == 0 else bz - 1)
        ops += 2 * 9 * KB * width * packs * X * Y
    sites = B * bz * X * Y
    nbytes = sites * (pC * esz + p * Co * esz + p)
    nbytes += 2 * 9 * KB * sum(w for *_, w in kblocks(p, C, Co))
    if mode != "mask":
        nbytes += 3 * Co * 4
    if mode == "bn_res_relu":
        nbytes += sites * p * Co * esz
    return ops, nbytes


def k2_bwd_work(shape, p, Co, esz, kind):
    """(FLOP, bytes) of one dX ("dx") or dW ("dw") call, counted as
    k2_work counts the forward."""
    B, bz, X, Y, pC = shape
    C = pC // p
    ops, _ = k2_work(shape, p, Co, "mask", esz)
    sites = B * bz * X * Y
    nbytes = sites * (pC + p * Co) * esz
    if kind == "dx":
        nbytes += 2 * 9 * KB * sum(w for *_, w in kblocks(p, C, Co))
    else:
        nbytes += 27 * C * Co * 4
    return ops, nbytes
