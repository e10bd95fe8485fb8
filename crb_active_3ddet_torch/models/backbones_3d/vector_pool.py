"""Vector-pool aggregation (PV-RCNN++'s local feature learning), torch: port
of ``crb_active_3ddet_tpu/models/backbones_3d/vector_pool.py`` (reference
``pcdet/ops/pointnet2/pointnet2_stack/pointnet2_modules.py``
VectorPoolAggregationModule and VectorPoolAggregationModuleMSG).

Each query point spreads a lattice of G = gx·gy·gz sub-voxel centres over
its ±R neighbourhood, gives every centre the three-NN inverse-distance
interpolation of the (channel-reduced) support features, zero where the
nearest support lies beyond 2R, and applies a separate learned kernel to
each sub-voxel position ([offset | interpolated] → 32 channels), then
BatchNorm and ReLU over every (B, M, G) row, the flattened G·32 through the
bias-free POST_MLPS, and zeroes the invalid queries.  The MSG module
concatenates [query xyz | groups] into MSG_POST_MLPS.  As in the JAX
module the position encoding is the centre's 3-channel offset (the CUDA
op of the reference also returns the three neighbours' offsets, 9
channels), and the BatchNorms take Flax's statistics over every row,
invalid queries included (``models/flax_layers.py``).

Modules: ``layers.{k}`` (one a group: ``local_kernel`` (G, 3 + C_red, 32),
``local_bn``, ``post_mlps``) and ``msg_post_mlps``; Linear + BatchNorm1d
stacks, channels-last.

The three-NN of the sub-voxel centres is this layer's volume: the JAX
module computes it as dense, chunked distance blocks over the whole
support buffer (``_chunked_three_interpolate``, kept here as the plain
form, ``three_nn_dense``).  ``three_nn_lattice`` returns the same indices
and distances from fewer pairs: every centre of a query point k lies within
ρ (the lattice's reach) of k, so each support among a centre's three
nearest, ties included, lies within d₃(k) + 2ρ of k, where d₃(k) is k's own
third-neighbour distance.  The valid supports inside that ball (its radius
widened by 1e-4 of itself and a centimetre, for rounding), in index order,
are k's candidates; each centre's squared distances to them are computed
by the dense form's formula in its order, so its ``argmin`` passes pick the
same supports, the lower index on ties.  A query point with more than
``CANDIDATE_CAP`` candidates, with fewer than 3 valid supports, or whose
ball reaches the invalid supports' squared distance ``_BIG``, is computed
densely.  The distances are then taken at the picked supports by the same
formula (an invalid support at ``_BIG``), so both forms return equal bits,
and autograd sees only the 3 picked supports of each centre.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops import pointnet2 as pn2
from .pfe import pointwise_stack, run_pointwise

_BN_EPS = 1e-3
# the pruned route: at most this many candidates a query point (more go
# dense), and the slack on each candidate ball's radius
CANDIDATE_CAP = 16384
_SLACK_REL, _SLACK_ABS = 1e-4, 1e-2          # , m


def _sub_voxel_offsets(r, num_voxels):
    """(G, 3) float64 lattice of sub-voxel centres spanning ±r, x-major
    (the JAX function; the module casts it to float32)."""
    grids = [np.arange(-r + r / n, r - r / n + 1e-5, 2 * r / n)
             for n in num_voxels]
    gx, gy, gz = np.meshgrid(*grids, indexing='ij')
    return np.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], axis=1)


def lattice_reach(offsets):
    """The largest distance of a sub-voxel centre from its query point."""
    return float(np.sqrt((np.asarray(offsets, np.float64) ** 2).sum(-1)).max())


def three_nn_dense(centres, support_xyz, support_valid):
    """The plain form: centres (B, M, G, 3) against every support, (B, N, 3)
    with validity (B, N) → dist and idx (B, M·G, 3), as ``pn2.three_nn``."""
    b, m, g, _ = centres.shape
    return pn2.three_nn(centres.reshape(b, m * g, 3), None, support_xyz, support_valid)


def interpolate_near(support_feat, dist, idx, max_dist):
    """(B, N, C) support features at the three-NN ``dist`` and ``idx``
    (B, Q, 3) → (B, Q, C) interpolations, zero where the nearest support
    lies beyond ``max_dist`` (the second and third are not limited)."""
    feat = pn2.three_interpolate(support_feat, idx, dist)
    return feat.masked_fill(~(dist[..., :1] <= max_dist), 0.0)


def _chunked_three_interpolate(support_xyz, support_valid, support_feat, queries, max_dist):
    """The JAX function's dense form: (B, N, 3) supports with validity and
    (B, N, C) features, (B, Q, 3) queries → (B, Q, C) ``interpolate_near``
    over the dense three-NN."""
    dist, idx = pn2.three_nn(queries, None, support_xyz, support_valid)
    return interpolate_near(support_feat, dist, idx, max_dist)


@torch.no_grad()
def _candidates(q, xyz, valid, reach):
    """One frame: query points q (M, 3), supports xyz (N, 3) with N ≥ 3,
    valid (N,) → (count (M,), ok (M,), the candidates' support indices
    laid end to end in query order (P,)).  ``ok`` marks the query points
    of the pruned route; the others count 0 here."""
    m, n = q.shape[0], xyz.shape[0]
    inf = torch.full((), float('inf'), dtype=xyz.dtype, device=xyz.device)
    counts, oks, cols = [], [], []
    rows = max(1, pn2._PAIR_CHUNK // n)
    for r0 in range(0, m, rows):
        d2 = torch.where(valid[None], pn2._sq_dist(q[None, r0:r0 + rows], xyz[None])[0], inf)
        d3 = torch.topk(d2, 3, dim=-1, largest=False).values[:, 2]
        r = (torch.sqrt(d3) + 2.0 * reach) * (1.0 + _SLACK_REL) + _SLACK_ABS
        inside = d2 <= (r * r)[:, None]
        del d2
        cnt = inside.sum(-1)
        ok = (r * r < pn2._BIG) & (cnt <= CANDIDATE_CAP)
        inside &= ok[:, None]
        cols.append(inside.nonzero()[:, 1])
        counts.append(torch.where(ok, cnt, torch.zeros_like(cnt)))
        oks.append(ok)
    return torch.cat(counts), torch.cat(oks), torch.cat(cols)


def _row_chunks(counts, g):
    """(first, end) of row chunks over ascending ``counts`` (numpy) such
    that rows × g × the chunk's largest count stays within the pair
    chunk."""
    a, out = 0, []
    while a < len(counts):
        cost = np.arange(1, len(counts) - a + 1) * g * np.maximum(counts[a:], 1)
        b = a + max(1, int(np.searchsorted(cost, pn2._PAIR_CHUNK, side='right')))
        out.append((a, b))
        a = b
    return out


@torch.no_grad()
def _lattice_idx_one(q, centres, xyz, valid, reach):
    """One frame: query points q (M, 3), their centres (M, G, 3), supports
    (N, 3) with validity (N,) → (M, G, 3) int64 indices of each centre's
    three nearest supports (the module docstring's pruned route)."""
    m, g, _ = centres.shape
    dev = centres.device
    idx = torch.zeros((m, g, 3), dtype=torch.int64, device=dev)
    counts, ok, cols = _candidates(q, xyz, valid, reach)
    starts = torch.cumsum(counts, 0) - counts
    kept = torch.nonzero(ok)[:, 0]
    order = kept[torch.argsort(counts[kept], stable=True)]
    sorted_counts = counts[order].cpu().numpy()
    inf = torch.full((), float('inf'), dtype=xyz.dtype, device=dev)
    last = max(cols.numel() - 1, 0)
    for a, b in _row_chunks(sorted_counts, g):
        kid = order[a:b]
        slots = torch.arange(int(sorted_counts[b - 1]), device=dev)
        pad = slots[None] >= counts[kid][:, None]
        cand = torch.where(pad, 0, cols[torch.clamp(starts[kid][:, None] + slots, max=last)])
        cxyz = xyz[cand]                                        # (rows, cap, 3)
        cq = centres[kid]                                       # (rows, G, 3)
        d2 = None
        for c in range(3):                                      # pn2._sq_dist's order
            t = cq[:, :, None, c] - cxyz[:, None, :, c]
            t = t * t
            d2 = t if d2 is None else d2.add_(t)
        d2.masked_fill_(pad[:, None, :], inf)
        picks = []
        for _ in range(3):
            i = d2.argmin(dim=-1, keepdim=True)
            picks.append(i)
            d2.scatter_(-1, i, float('inf'))
        del d2
        idx[kid] = torch.gather(cand[:, None, :].expand(-1, g, -1), -1, torch.cat(picks, -1))
    dense = torch.nonzero(~ok)[:, 0]
    if dense.numel():
        _, didx = three_nn_dense(centres[dense][None], xyz[None], valid[None])
        idx[dense] = didx.reshape(-1, g, 3)
    return idx


def dist_at(queries, support_xyz, support_valid, idx):
    """Euclidean distances of (B, Q, 3) queries to the supports ``idx``
    (B, Q, 3) picked, by ``pn2.three_nn``'s formula: an invalid support
    sits at squared distance ``_BIG``."""
    b, q, _ = queries.shape
    flat = idx.reshape(b, q * 3)
    s = torch.gather(support_xyz, 1, flat[..., None].expand(-1, -1, 3)).reshape(b, q, 3, 3)
    d2 = None
    for c in range(3):
        t = queries[:, :, None, c] - s[..., c]
        t = t * t
        d2 = t if d2 is None else d2 + t
    ok = torch.gather(support_valid, 1, flat).reshape(b, q, 3)
    d2 = torch.where(ok, d2, torch.full((), pn2._BIG, dtype=d2.dtype, device=d2.device))
    return torch.sqrt(torch.clamp(d2, min=0.0))


def three_nn_lattice(new_xyz, centres, support_xyz, support_valid, reach):
    """The three nearest valid supports of every sub-voxel centre: query
    points (B, M, 3), their centres (B, M, G, 3), all within ``reach`` of
    their query point, supports (B, N, 3) with validity (B, N) → dist and
    idx (B, M·G, 3), equal to ``three_nn_dense`` (the module docstring)."""
    b, m, g, _ = centres.shape
    if support_xyz.shape[1] < 3:           # (the JAX three-NN needs 3 supports)
        return three_nn_dense(centres, support_xyz, support_valid)
    idx = torch.stack([_lattice_idx_one(new_xyz[f], centres[f], support_xyz[f],
                                        support_valid[f], reach) for f in range(b)])
    idx = idx.reshape(b, m * g, 3)
    return dist_at(centres.reshape(b, m * g, 3), support_xyz, support_valid, idx), idx


class VectorPoolAggregation(nn.Module):
    """One vector-pool group (reference VectorPoolAggregationModule)."""

    def __init__(self, in_channels, num_local_voxel=(3, 3, 3), max_neighbor_distance=1.2,
                 post_mlps=(64,), num_reduced_channels=16,
                 num_channels_of_local_aggregation=32):
        super().__init__()
        self.num_local_voxel = tuple(int(n) for n in num_local_voxel)
        self.max_neighbor_distance = float(max_neighbor_distance)
        self.c_in = int(in_channels)
        self.c_red = min(int(num_reduced_channels), self.c_in)
        if self.c_in > self.c_red and self.c_in % self.c_red:
            raise ValueError(f'{self.c_in} channels do not reduce to {self.c_red}')
        offsets = _sub_voxel_offsets(self.max_neighbor_distance, self.num_local_voxel)
        self.reach = lattice_reach(offsets.astype(np.float32))
        self.register_buffer('offsets', torch.from_numpy(offsets.astype(np.float32)),
                             persistent=False)
        g = len(offsets)
        c_local = int(num_channels_of_local_aggregation)
        self.local_kernel = nn.Parameter(torch.zeros(g, 3 + self.c_red, c_local))
        self.local_bn = nn.Sequential(nn.BatchNorm1d(c_local, eps=_BN_EPS, momentum=0.01),
                                      nn.ReLU())
        self.post_mlps = pointwise_stack([g * c_local, *post_mlps], nn.Linear, nn.BatchNorm1d)
        self.num_out_channels = int(post_mlps[-1])

    def reduce_channels(self, features):
        """(…, C) → (…, C_red): the grouped sum of consecutive channels."""
        if self.c_in > self.c_red:
            return features.reshape(*features.shape[:-1], self.c_red,
                                    self.c_in // self.c_red).sum(-1)
        return features

    def forward(self, xyz, xyz_valid, new_xyz, new_xyz_valid, features):
        """xyz (B, N, 3), features (B, N, C), new_xyz (B, M, 3) →
        (B, M, POST_MLPS[-1])."""
        b, m = new_xyz.shape[:2]
        g = self.offsets.shape[0]
        feats = self.reduce_channels(features.to(xyz.dtype))
        centres = new_xyz[:, :, None, :] + self.offsets             # (B, M, G, 3)
        dist, idx = three_nn_lattice(new_xyz, centres, xyz, xyz_valid, self.reach)
        interp = interpolate_near(feats, dist, idx, 2.0 * self.max_neighbor_distance)
        x = torch.cat([self.offsets.expand(b, m, g, 3),
                       interp.reshape(b, m, g, self.c_red)], dim=-1)  # (B, M, G, 3 + C)
        x = torch.einsum('bmgc,gco->bmgo', x, self.local_kernel)
        x = run_pointwise(self.local_bn, x).reshape(b, m, -1)
        x = run_pointwise(self.post_mlps, x)
        return x.masked_fill(~new_xyz_valid[..., None], 0.0)


class VectorPoolAggregationMSG(nn.Module):
    """Several vector-pool groups, then [new_xyz | groups] through
    MSG_POST_MLPS (reference VectorPoolAggregationModuleMSG); ``config``
    carries NUM_GROUPS, GROUP_CFG_k, NUM_REDUCED_CHANNELS,
    NUM_CHANNELS_OF_LOCAL_AGGREGATION and MSG_POST_MLPS."""

    def __init__(self, config, in_channels):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorPoolAggregation(
                in_channels, config[f'GROUP_CFG_{k}']['NUM_LOCAL_VOXEL'],
                config[f'GROUP_CFG_{k}']['MAX_NEIGHBOR_DISTANCE'],
                config[f'GROUP_CFG_{k}']['POST_MLPS'],
                config.get('NUM_REDUCED_CHANNELS', in_channels),
                config['NUM_CHANNELS_OF_LOCAL_AGGREGATION'])
            for k in range(int(config['NUM_GROUPS'])))
        c = 3 + sum(layer.num_out_channels for layer in self.layers)
        self.msg_post_mlps = pointwise_stack([c, *config['MSG_POST_MLPS']], nn.Linear,
                                             nn.BatchNorm1d)
        self.num_out_channels = int(config['MSG_POST_MLPS'][-1])

    def forward(self, xyz, xyz_valid, new_xyz, new_xyz_valid, features):
        outs = [layer(xyz, xyz_valid, new_xyz, new_xyz_valid, features)
                for layer in self.layers]
        x = run_pointwise(self.msg_post_mlps, torch.cat([new_xyz, *outs], dim=-1))
        return x.masked_fill(~new_xyz_valid[..., None], 0.0)


def kaiming_normal_(kernel, generator):
    """Flax's ``kaiming_normal`` (he normal: a normal truncated at ±2 of its
    scale, std √(2 / fan_in)) of a (G, C, O) local kernel, whose fan-in
    Flax counts as G·C."""
    fan_in = kernel.shape[0] * kernel.shape[1]
    scale = math.sqrt(2.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(kernel, 0.0, scale, -2 * scale, 2 * scale, generator=generator)
