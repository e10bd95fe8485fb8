"""Rulebook construction for sparse 3D conv (torch).

Port of the parts of ``crb_active_3ddet_tpu/ops/sparse/rulebook.py`` that the
SECOND backbone runs: the windowed sort-join submanifold rulebook
(``subm_rulebook_window`` :383, ``unpack_window_rulebook`` :391), the
sort-based strided rulebook (``downsample_rulebook`` :548),
``conv_out_grid`` (:117) and ``inverse_rulebook`` (:707), which the
backward's input gradient runs over.  They replace spconv's GPU hash tables
(``pcdet/utils/spconv_utils.py``) with sorts over voxel cell ids.

Conventions: coords are (V, 3) integer (z, y, x) with a validity mask; a
rulebook entry is an input row index or −1 (no neighbour).  Every sort is
stable and every result is independent of the order of tied keys, so the
rulebooks equal the JAX ones element for element.  All samples run at
once: ``torch.sort`` along the last dim sorts each sample on its own, and
the scans run along the same dim.
"""

from __future__ import annotations

import torch

_BIG = 2 ** 62   # sort key past every real entry (int64)


def conv_out_grid(grid, kernel_size, stride, padding):
    """Static output grid of a strided sparse conv."""
    return tuple((g + 2 * p - k) // s + 1
                 for g, k, s, p in zip(grid, kernel_size, stride, padding))


def _row_value(table, rows, fill):
    """table (B, V) at rows (B, L) where 0 ≤ rows < V, else ``fill``."""
    v = table.shape[1]
    got = torch.gather(table, 1, torch.clamp(rows, 0, v - 1))
    return torch.where((rows >= 0) & (rows < v), got, torch.full_like(got, fill))


def subm_rulebook_window(coords, valid, grid):
    """(B, V, 9) packed windowed subm rulebook, all samples at once.

    Same algorithm and packing as the JAX ``_subm_rulebook_window_single``:
    keys (the voxel cells) and queries (the 9 (dz, dy) neighbour cells at
    dx = 0 of every voxel) are sorted together per sample; for each query,
    the three dx-taps live in the window of cell-sorted voxel rows
    {lastrow−1, lastrow, lastrow+1}, where lastrow is the row of the last key
    at or before it.  The packed entry is ``wrow·32 + code`` (or −1), with
    code bits
      bit0: dx=−1 ← row wrow−1    bit1: dx=−1 ← row wrow
      bit2: dx= 0 ← row wrow
      bit3: dx=+1 ← row wrow+1    bit4: dx=+1 ← row wrow (no key ≤ query).
    Requires coords cell-sorted with the valid rows first (the voxelizer's
    and downsample's order) — so the k-th key in sorted order is row k, and
    the JAX scans that carry the last key's cell and previous cell become
    gathers from the per-row cells.
    """
    b, v, _ = coords.shape
    nz, ny, nx = grid
    dev = coords.device
    coords = coords.to(torch.int64)

    in_b = ((coords >= 0).all(-1) & (coords[..., 0] < nz)
            & (coords[..., 1] < ny) & (coords[..., 2] < nx))
    ok_v = valid & in_b
    cell = (coords[..., 0] * ny + coords[..., 1]) * nx + coords[..., 2]
    rowcell = torch.where(ok_v, cell, torch.full_like(cell, -1))

    big = torch.full_like(cell, _BIG)
    ar = torch.arange(v, dtype=torch.int64, device=dev).expand(b, v)
    sk = [torch.where(ok_v, cell * 2, big)]
    pos = [torch.full((b, v), 9 * v, dtype=torch.int64, device=dev)]
    for g, (dz, dy) in enumerate([(a, c) for a in (-1, 0, 1)
                                  for c in (-1, 0, 1)]):
        zz = coords[..., 0] + dz
        yy = coords[..., 1] + dy
        okq = ok_v & (zz >= 0) & (zz < nz) & (yy >= 0) & (yy < ny)
        cq = (zz * ny + yy) * nx + coords[..., 2]
        sk.append(torch.where(okq, cq * 2 + 1, big))
        pos.append(ar * 9 + g)
    sk_s, perm = torch.sort(torch.cat(sk, 1), dim=1, stable=True)
    pos_s = torch.gather(torch.cat(pos, 1), 1, perm)

    is_key = ((sk_s & 1) == 0) & (sk_s < _BIG)
    lastrow = torch.cumsum(is_key.to(torch.int64), 1) - 1
    lastcell = _row_value(rowcell, lastrow, -1)
    lastprev = _row_value(rowcell, lastrow - 1, -1)
    nextcell = _row_value(rowcell, lastrow + (~is_key).to(torch.int64), -1)

    cq = sk_s >> 1
    xq = cq % nx
    has_last = lastrow >= 0
    hit0 = has_last & (lastcell == cq)
    b0 = (xq >= 1) & hit0 & (lastprev == cq - 1)
    b1 = (xq >= 1) & has_last & (lastcell == cq - 1)
    p1v = (xq <= nx - 2) & (nextcell == cq + 1)
    b3 = p1v & has_last
    b4 = p1v & ~has_last
    code = (b0.to(torch.int64) + 2 * b1 + 4 * hit0 + 8 * b3 + 16 * b4)
    wrow = torch.where(has_last, lastrow, torch.zeros_like(lastrow))
    packed = torch.where(code > 0, wrow * 32 + code, torch.full_like(code, -1))

    # back to query order; keys (pos = 9V) land past the slice
    out = torch.full((b, 9 * v + 1), -1, dtype=torch.int64, device=dev)
    out.scatter_(1, pos_s, packed)
    return out[:, :9 * v].reshape(b, v, 9).to(torch.int32)


def unpack_window_rulebook(packed):
    """Expand a (..., 9) packed windowed rulebook to (..., 27) tap columns,
    row-major over (kz, ky, kx) like the plain rulebook."""
    wrow = packed >> 5
    code = packed & 31
    none = torch.full_like(wrow, -1)
    m1 = torch.where((code & 1) > 0, wrow - 1,
                     torch.where((code & 2) > 0, wrow, none))
    d0 = torch.where((code & 4) > 0, wrow, none)
    p1 = torch.where((code & 8) > 0, wrow + 1,
                     torch.where((code & 16) > 0, wrow, none))
    cols = torch.stack([m1, d0, p1], dim=-1)
    cols = torch.where(packed[..., None] < 0, torch.full_like(cols, -1), cols)
    return cols.reshape(*packed.shape[:-1], 27)


def downsample_rulebook(in_coords, in_valid, grid, kernel_size, stride,
                        padding, max_out: int):
    """Strided-conv active sites and rulebook from one sort per sample.

    (B, V, 3) coords + (B, V) valid → out_coords (B, max_out, 3) int32,
    out_valid (B, max_out), rulebook (B, max_out, K³) int32 with −1 for no
    input.  Each input enumerates its ≤ ⌈K/s⌉³ (output site, offset)
    candidates (k = ((i+p) mod s) + s·b); sorting the output cells gives the
    sites in ascending cell order (capped at ``max_out``) and fills the
    rulebook, as in the JAX ``downsample_rulebook``.
    """
    ks, st, pd = kernel_size, stride, padding
    noz, noy, nox = conv_out_grid(grid, ks, st, pd)
    kt = ks[0] * ks[1] * ks[2]
    b = in_coords.shape[0]
    dev = in_coords.device
    in_coords = in_coords.to(torch.int64)

    n_cand = [-(-k // s) for k, s in zip(ks, st)]
    b_offs = torch.stack(torch.meshgrid(
        *[torch.arange(c, device=dev) for c in n_cand], indexing='ij'),
        dim=-1).reshape(-1, 3)                                    # (C, 3)
    nc = b_offs.shape[0]
    st_t = torch.tensor(st, device=dev)
    ks_t = torch.tensor(ks, device=dev)
    ip = in_coords + torch.tensor(pd, device=dev)
    k_cand = (ip % st_t)[:, :, None, :] + b_offs * st_t           # (B, V, C, 3)
    k_ok = (k_cand < ks_t).all(-1)
    o = torch.div(ip[:, :, None, :] - k_cand, st_t, rounding_mode='floor')
    in_bounds = ((o >= 0).all(-1) & (o[..., 0] < noz) & (o[..., 1] < noy)
                 & (o[..., 2] < nox))
    ok = k_ok & in_bounds & in_valid[:, :, None]

    kflat = (k_cand[..., 0] * (ks[1] * ks[2]) + k_cand[..., 1] * ks[2]
             + k_cand[..., 2]).reshape(b, -1)
    h = o[..., 0] * (noy * nox) + o[..., 1] * nox + o[..., 2]
    h = torch.where(ok, h, torch.full_like(h, _BIG)).reshape(b, -1)

    h_sorted, perm = torch.sort(h, dim=1, stable=True)
    k_e = torch.gather(kflat, 1, perm)
    i_e = perm // nc
    first = torch.ones_like(h_sorted, dtype=torch.bool)
    first[:, 1:] = h_sorted[:, 1:] != h_sorted[:, :-1]
    first &= h_sorted != _BIG
    slot = torch.cumsum(first.to(torch.int64), 1) - 1
    n_out = first.sum(1, keepdim=True)

    # output cells by slot, capped at max_out (column max_out: discarded)
    dump = torch.full_like(slot, max_out)
    out_h = torch.zeros((b, max_out + 1), dtype=torch.int64, device=dev)
    out_h.scatter_(1, torch.where(first & (slot < max_out), slot, dump), h_sorted)
    out_h = out_h[:, :max_out]
    out_valid = torch.arange(max_out, device=dev) < torch.clamp(n_out, max=max_out)
    out_coords = torch.stack([out_h // (noy * nox), (out_h % (noy * nox)) // nox,
                              out_h % nox], dim=-1)
    out_coords = torch.where(out_valid[..., None], out_coords,
                             torch.full_like(out_coords, -1))

    # rulebook[slot, k] = input row; (slot, k) pairs are unique
    valid_e = (h_sorted != _BIG) & (slot < max_out)
    rulebook = torch.full((b, max_out * kt + 1), -1, dtype=torch.int64, device=dev)
    rulebook.scatter_(1, torch.where(valid_e, slot * kt + k_e,
                                     torch.full_like(slot, max_out * kt)), i_e)
    return (out_coords.to(torch.int32), out_valid,
            rulebook[:, :max_out * kt].reshape(b, max_out, kt).to(torch.int32))


def inverse_rulebook(rulebook, v_in: int):
    """Invert a rulebook: (V_out, K) with entry [o, k] = input row i (or −1)
    → (v_in, K) int32 with entry [i, k] = o, or −1.

    Port of the JAX ``inverse_rulebook`` for any rulebook, subm or strided,
    here over the flat (B·V_out, K) rulebook of a layer.  The o is unique for
    each (i, k): the output o = (i + p − k)/s that offset k of input i feeds
    is unique.  One scatter; as in the JAX version, each −1 entry goes to a
    distinct row past the end (here one of V_out·K slots that are cut off),
    so no two writes meet."""
    v_out, k = rulebook.shape
    dev = rulebook.device
    o = torch.arange(v_out, dtype=torch.int32, device=dev)[:, None].expand(v_out, k)
    slot = torch.arange(v_out * k, dtype=torch.int64, device=dev).view(v_out, k)
    flat = torch.where(rulebook >= 0,
                       rulebook.to(torch.int64) * k + torch.arange(k, device=dev),
                       v_in * k + slot)
    inv = torch.full((v_in * k + v_out * k,), -1, dtype=torch.int32, device=dev)
    inv.scatter_(0, flat.reshape(-1), o.reshape(-1))
    return inv[:v_in * k].view(v_in, k)


def transpose_rulebook(rulebook):
    """(V_out, K) rulebook → (K, V_out) int32, contiguous: the layout in which
    the weight-gradient kernels (``ops/cuda_kernels.py``, both routes) read
    one offset's column coalesced.  Built once per rulebook, beside its inverse,
    when a gradient is wanted."""
    return rulebook.t().contiguous()
