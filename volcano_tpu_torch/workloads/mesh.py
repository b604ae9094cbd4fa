"""Device mesh construction for the workload layer — the port of
`volcano_tpu.workloads.mesh` on `torch.distributed.device_mesh`.

Axes follow the reference:
  dp    - data parallel (pure replication of params, sharded batch)
  fsdp  - fully-sharded data parallel (params sharded, batch sharded)
  tp    - tensor parallel (params + activations sharded on hidden dims)
  sp    - sequence/context parallel (ring attention over seq dim)
  dcn   - multi-slice data parallel (make_hybrid_mesh only): the slow
          tier between slices; OUTERMOST, so only the batch-gradient
          reduction crosses it

One process drives one GPU, so a mesh coordinate is a rank; a pod of
several GPUs runs several consecutive ranks, which share its slice id.
The default process group must exist before a mesh is built
(`bootstrap.initialize`): `init_device_mesh` would otherwise start an
`env://` group of its own.  The training step shards params over fsdp
and tp, the batch over dcn, dp and fsdp, and the sequence over sp
(`model.param_shardings`, `train.batch_sharding`); sp's groups lie
inside a slice on a hybrid mesh, so the ring's hops and Ulysses'
all-to-alls never cross dcn.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from volcano_tpu_torch.workloads.device import resolve_device

AXES = ("dp", "fsdp", "tp", "sp")
HYBRID_AXES = ("dcn",) + AXES


def choose_axis_sizes(n_devices: int,
                      tp: Optional[int] = None,
                      sp: Optional[int] = None,
                      fsdp: Optional[int] = None) -> Dict[str, int]:
    """Pick a sensible 4-axis factorization of n_devices.

    Defaults: tp up to 4 (intra-host ICI), sp up to 2 when devices
    remain, rest into fsdp; dp=1 (fsdp subsumes it) unless forced.
    """
    remaining = n_devices

    def take(want, pow2_only=False):
        nonlocal remaining
        size = 1
        candidates = [want] if want else []
        if pow2_only:
            # model dims (heads, hidden) are powers of two; tp/sp must
            # divide them, so restrict auto-picked sizes to powers of 2
            candidates += [c for c in (4, 2, 1) if c <= remaining]
        else:
            candidates += list(range(remaining, 0, -1))
        for cand in candidates:
            if cand and remaining % cand == 0:
                size = cand
                break
        remaining //= size
        return size

    tp_size = take(tp, pow2_only=tp is None)
    sp_size = take(sp if sp is not None
                   else (2 if remaining % 2 == 0 else 1))
    # fsdp shards parameter dims, so it too must divide power-of-two
    # model dims: absorb every remaining factor of 2; any awkward odd
    # factor lands on dp, which only shards the batch (whose size the
    # caller controls).
    if fsdp is not None:
        fsdp_size = take(fsdp)
    else:
        fsdp_size = 1
        while remaining % 2 == 0:
            fsdp_size *= 2
            remaining //= 2
    dp_size = remaining  # whatever is left
    return {"dp": dp_size, "fsdp": fsdp_size, "tp": tp_size, "sp": sp_size}


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call bootstrap.initialize() "
                           "before building a mesh")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    return resolve_device(device_type).type


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (dp, fsdp, tp, sp) mesh over every rank of the default group,
    in rank order (sp innermost: an sp group is consecutive ranks).
    `device_type`: `cuda` (the default) or `cpu`."""
    n = _world_size()
    if axis_sizes is None:
        axis_sizes = choose_axis_sizes(n)
    shape = tuple(axis_sizes.get(a, 1) for a in AXES)
    if int(np.prod(shape)) != n:
        raise ValueError(f"axis sizes {axis_sizes} != {n} devices")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=AXES)


def sub_mesh(mesh: DeviceMesh, axes: Sequence[str], name: str) -> DeviceMesh:
    """The 1-D sub-mesh of `axes` (in mesh order; they need not be
    adjacent), flattened under `name` when there are several.  Every
    rank of the mesh must call it at the same point the first time
    (flattening forms a group); later calls return the same mesh."""
    axes = tuple(axes)
    return mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten(name)


def group_by_slice(ranks: Sequence[int], num_slices: int,
                   slice_ids: Optional[Sequence[Optional[int]]] = None
                   ) -> List[List[int]]:
    """Partition ranks into their slices, best signal first: each rank's
    slice id (`TPU_SLICE_ID`, aligned with `ranks`), used only when its
    distinct ids number `num_slices` and the groups are equal; else equal
    sequential chunks in rank order.  (The reference's middle tier, the
    process index, gives the chunks' groups when a process drives one
    GPU.)  A pod's ranks are consecutive and carry its slice id, so
    either way they land in its slice.  Returns num_slices lists of
    equal length, ordered by slice id."""
    ranks = list(ranks)
    groups = None
    if slice_ids is not None and None not in slice_ids:
        keys = sorted(set(slice_ids))
        by_id = [[r for r, i in zip(ranks, slice_ids) if i == k]
                 for k in keys]
        if len(keys) == num_slices and len({len(g) for g in by_id}) == 1:
            groups = by_id
    if groups is None:
        if len(ranks) % num_slices:
            raise ValueError(
                f"{len(ranks)} devices not divisible into "
                f"{num_slices} slices")
        per = len(ranks) // num_slices
        groups = [ranks[i * per:(i + 1) * per] for i in range(num_slices)]
    return groups


def make_hybrid_mesh(axis_sizes: Dict[str, int],
                     device_type: Optional[str] = None,
                     slice_id: Optional[int] = None) -> DeviceMesh:
    """Two-level mesh: axis_sizes['dcn'] slices, each holding a full
    (dp, fsdp, tp, sp) sub-mesh of the ranks of one slice, with `dcn`
    outermost, so every sp group lies inside one slice.  Every rank passes its slice id (`TPU_SLICE_ID`, None
    when unknown); they are gathered to group the ranks
    (`group_by_slice`)."""
    n = _world_size()
    num_slices = axis_sizes.get("dcn", 1)
    ici_shape = tuple(axis_sizes.get(a, 1) for a in AXES)
    per_slice = int(np.prod(ici_shape))
    if num_slices * per_slice != n:
        raise ValueError(f"axis sizes {axis_sizes} != {n} devices")
    dev_type = _device_type(device_type)
    slice_ids: List[Optional[int]] = [None] * n
    dist.all_gather_object(slice_ids, slice_id)
    groups = group_by_slice(range(n), num_slices, slice_ids)
    if any(len(g) != per_slice for g in groups):
        raise ValueError(
            f"slice sizes {[len(g) for g in groups]} != ICI mesh "
            f"{ici_shape} ({per_slice} devices per slice)")
    arr = np.stack([np.asarray(g).reshape(ici_shape) for g in groups])
    return DeviceMesh(dev_type, torch.from_numpy(arr),
                      mesh_dim_names=HYBRID_AXES)
