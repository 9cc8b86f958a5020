"""Device mesh and the sharding rules of the dp x tp serving tier. Twin
of qwen3_tts_tpu/parallel/mesh.py, on torch.distributed.

JAX runs one controller over every device and lets XLA insert the
collectives from PartitionSpecs. Here each device has a process of its
own (a rank), every rank holds only its own shard, and the collectives
are written out where the math needs them:

- tp (Megatron): q/k/v and gate/up column-parallel, o and down
  row-parallel, so a transformer layer adds up its o and down products
  over the tp group (``tp_all_reduce``, on the f32 partial sums); the
  vocab-sharded codec_head and lm_heads and the column-parallel mtp_proj
  gather their columns (``tp_all_gather``); the vocab-sharded text
  embedding is a masked local lookup summed over the group.
- dp: the batch rows split over dp groups, which issue no collective on
  the data path (the batcher gathers its host status once a chunk).

A parameter spec says which dim of a leaf is split over tp (an int) or
None (replicated); the vocoder and every other entry stay whole. The
decode state's local shapes follow from the same layout where it is
built: models/transformer.geometry_of gives a tp rank its kv heads, and
multihost.host_slot_range a dp group its rows (and, paged, its
sub-pool).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from qwen3_tts_tpu_torch.ops.quant import QTensor, attach_layer_list

DP, TP = "dp", "tp"


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """A mesh member: the rank (process) that drives a device, the
    device, and the host it sits on."""

    rank: int
    device: str
    host: str = ""


class Mesh:
    """A (dp, tp) grid of RankDevice and this rank's place in it: its
    ``(dp_index, tp_index)``, its ``device``, and the process groups of
    the world, of its tp group (its grid row) and of its dp group (its
    grid column). ``shape`` is ``{"dp": dp, "tp": tp}``. Without a
    distributed world the groups are None: a one-rank mesh, or a layout
    that issues no collective."""

    def __init__(self, devices: np.ndarray, rank: int = 0):
        self.devices = devices
        dp, tp = devices.shape
        self.shape = {DP: dp, TP: tp}
        self.rank = rank
        where = [(i, j) for i in range(dp) for j in range(tp)
                 if devices[i, j].rank == rank]
        if not where:
            raise ValueError(f"rank {rank} is not in the {dp}x{tp} mesh")
        self.dp_index, self.tp_index = where[0]
        self.device = torch.device(devices[where[0]].device)
        self.world = self.tp_group = self.dp_group = None

    def __repr__(self):
        return (f"Mesh(dp{self.shape[DP]}xtp{self.shape[TP]}, rank "
                f"{self.rank} at ({self.dp_index}, {self.tp_index}) on "
                f"{self.device})")


def as_rank_devices(devices=None) -> list:
    """RankDevice descriptors: the world's (multihost.world_devices) by
    default; device names or torch.devices become the descriptors of
    ranks 0, 1, ... on this host (one card may be listed twice)."""
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    world = mh.world_devices()
    if devices is None:
        return world
    out = []
    for i, d in enumerate(devices):
        if not isinstance(d, RankDevice):
            host = world[i].host if i < len(world) else world[0].host
            d = RankDevice(i, str(torch.device(d)), host)
        out.append(d)
    return out


def mesh_from_grid(grid: np.ndarray) -> Mesh:
    """The Mesh of this rank over ``grid`` (dp, tp) of RankDevice. In a
    distributed world of more than one rank every rank must hold one
    position, and every rank builds the same groups in the same order
    (``dist.new_group`` is itself collective)."""
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    rank = mh.process_index()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return Mesh(grid, rank)
    world = dist.get_world_size()
    held = sorted(d.rank for d in grid.flat)
    if held != list(range(world)):
        raise ValueError(f"the {grid.shape[0]}x{grid.shape[1]} mesh holds "
                         f"ranks {held} of a world of {world}: every rank "
                         "must hold one position")
    mesh = Mesh(grid, rank)
    tp_groups = [dist.new_group([d.rank for d in row]) for row in grid]
    dp_groups = [dist.new_group([d.rank for d in col]) for col in grid.T]
    mesh.world = dist.group.WORLD
    mesh.tp_group = tp_groups[mesh.dp_index]
    mesh.dp_group = dp_groups[mesh.tp_index]
    return mesh


def make_mesh(dp: int, tp: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """A dp x tp mesh over the first dp*tp devices in order, so rank r
    sits at (r // tp, r % tp). ``devices``: the world's ranks by default
    (one ``cuda:local_rank`` each), or device names."""
    devs = as_rank_devices(devices)
    if len(devs) < dp * tp:
        raise ValueError(f"need {dp * tp} devices, have {len(devs)}")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devs[:dp * tp]):
        grid[i // tp, i % tp] = d
    return mesh_from_grid(grid)


# ---------------------------------------------------------------------------
# Collectives (each call site writes one out; no-ops without tp)
# ---------------------------------------------------------------------------

def tp_active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.shape[TP] > 1


def tp_all_reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum x over the tp group, in place: the f32 partial sums of a
    row-parallel product, or a masked lookup that is zero off this rank's
    rows. Every rank gets the same bits."""
    if tp_active(mesh):
        dist.all_reduce(x, group=mesh.tp_group)
    return x


def _gather_last(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The n ranks' x (..., m) of ``group`` concatenated in rank order
    along the last dim: (..., n * m)."""
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    out = flat.new_empty((n * flat.shape[0], flat.shape[1]))
    dist.all_gather_into_tensor(out, flat, group=group)
    out = out.reshape(n, *flat.shape).permute(1, 0, 2)
    return out.reshape(*x.shape[:-1], n * x.shape[-1])


def tp_all_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Each tp rank's x (..., n) concatenated in tp order along the last
    dim: (..., tp * n)."""
    if not tp_active(mesh):
        return x
    return _gather_last(x, mesh.shape[TP], mesh.tp_group)


def tp_broadcast_flag(flag: bool, mesh: Optional[Mesh]) -> bool:
    """tp rank 0's ``flag`` on every rank of its tp group (a host tensor,
    so gloo carries it): a decision that the group must take as one."""
    if not tp_active(mesh):
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.broadcast(t, src=mesh.devices[mesh.dp_index, 0].rank,
                   group=mesh.tp_group)
    return bool(t.item())


def dp_all_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Each dp group's x (..., b) concatenated in dp order along the last
    dim, over this rank's dp group: the batcher's host status, a CPU
    tensor (gloo carries it)."""
    if mesh is None or mesh.shape[DP] == 1:
        return x
    return _gather_last(x, mesh.shape[DP], mesh.dp_group)


# ---------------------------------------------------------------------------
# Parameter specs: the dim split over tp, or None (replicated)
# ---------------------------------------------------------------------------

def layer_stack_spec() -> Dict[str, Optional[int]]:
    """The stacked layer dict (leading dim = layer, weights (L, K, N)):
    q/k/v and gate/up column-parallel (N), o and down row-parallel (K),
    norms replicated."""
    return {
        "input_ln": None,
        "q_proj": 2,
        "k_proj": 2,
        "v_proj": 2,
        "o_proj": 1,
        "q_norm": None,
        "k_norm": None,
        "post_ln": None,
        "gate_proj": 2,
        "up_proj": 2,
        "down_proj": 1,
    }


def talker_param_spec() -> Dict:
    return {
        "layers": layer_stack_spec(),
        "final_norm": None,
        "text_embedding": 0,         # vocab-sharded (the 151936-row table)
        "proj_fc1_w": 1,
        "proj_fc1_b": 0,
        "proj_fc2_w": 0,
        "proj_fc2_b": None,
        "codec_embedding": None,     # small; replicated for the gathers
        "codec_head": 1,             # vocab-sharded logits
    }


def cp_param_spec() -> Dict:
    return {
        "layers": layer_stack_spec(),
        "final_norm": None,
        "mtp_proj_w": 1,
        "mtp_proj_b": 0,
        "codec_embs": None,          # gathered per sampled token
        "lm_heads": 2,               # per-group vocab-sharded
    }


def _scale_spec(spec: Optional[int], ndim: int) -> Optional[int]:
    """The spec of a QTensor's per-column scales (..., N) given the int8
    payload's (..., K, N) spec: the contraction axis K is dropped, so a
    row-parallel weight keeps its whole scale vector."""
    if spec is None or spec == ndim - 2:
        return None
    return spec - 1 if spec == ndim - 1 else spec


def adapt_spec_to_params(spec, params):
    """A dense spec tree adapted to a params tree that may hold int8
    QTensor leaves (ops/quant.py): the payload keeps the dense weight's
    spec, its scales drop the contraction axis (_scale_spec). The
    per-layer ``layers_list`` entries take the stacked spec without the
    layer axis. The fused talker layout (qkv_proj / gateup_proj) has no
    spec: the mesh tier serves a dense talker and an optional int8 code
    predictor."""
    if isinstance(params, QTensor):
        return QTensor(spec, _scale_spec(spec, params.q.dim()))
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k == "layers_list" and "layers" in spec:
                per = {kk: None if sp is None else sp - 1
                       for kk, sp in spec["layers"].items()}
                out[k] = [adapt_spec_to_params(per, lyr) for lyr in v]
                continue
            if k not in spec:
                raise KeyError(
                    f"no sharding spec for param {k!r} (fused int8 layouts "
                    "are single-chip; quantize with fuse=False for the mesh)")
            out[k] = adapt_spec_to_params(spec[k], v)
        return out
    return spec


def shard_leaf(x: torch.Tensor, dim: Optional[int],
               mesh: Mesh) -> torch.Tensor:
    """This tp rank's slice of x along ``dim``, as a contiguous tensor of
    its own (the kernels need contiguous operands, and the whole weight
    is then freed); x itself when ``dim`` is None or tp is 1."""
    n = mesh.shape[TP]
    if dim is None or n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over tp={n}")
    part = x.narrow(dim, mesh.tp_index * (size // n), size // n)
    return part.clone(memory_format=torch.contiguous_format)


def _shard(tree, spec, mesh: Mesh):
    if isinstance(tree, QTensor):
        return QTensor(shard_leaf(tree.q, spec.q, mesh),
                       shard_leaf(tree.scale, spec.scale, mesh))
    if isinstance(tree, dict):
        return {k: _shard(v, spec[k], mesh) for k, v in tree.items()}
    return shard_leaf(tree, spec, mesh)


def shard_params(mesh: Mesh, params: Dict) -> Dict:
    """This rank's local shard of the talker and the code predictor (the
    vocoder and any other entry stay whole). ``layers_list`` views are
    rebuilt over the local stack."""
    out = dict(params)
    for name, spec_fn in (("talker", talker_param_spec),
                          ("code_predictor", cp_param_spec)):
        if name not in params:
            continue
        tree = {k: v for k, v in params[name].items() if k != "layers_list"}
        local = _shard(tree, adapt_spec_to_params(spec_fn(), tree), mesh)
        if "layers_list" in params[name]:
            local = attach_layer_list(local)
        out[name] = local
    return out
