"""Process groups and the collectives of chain-sharded runs (own port of
tmhpvsim_tpu/parallel/distributed.py over ``torch.distributed``).

One process per card: rank ``r`` of ``w`` owns the contiguous chains
``[r * n / w, (r + 1) * n / w)`` (``local_chain_slice``) and simulates
them with the whole run's keys (``carve_config``: ``split(seed key,
n_chains_total)`` sliced at the rank's offset, the site grid and fleet
rows sliced alike), so its per-chain results are the unsharded run's
rows of those chains.  What crosses processes is small and once per
block: the observers' block deltas and the per-second ensemble sums
(``all_reduce``), and at the end the fleet aggregates and the metrics
snapshots.

The collectives are the library's (``torch.distributed``: NCCL for CUDA
tensors, gloo for CPU ones).  Leaves are packed into one flat tensor per
reduction and dtype, so a block's observers cost about three
``all_reduce`` calls, not one per leaf.  MIN and MAX keep NaN and order
-0.0 below +0.0, as the JAX package's ``pmin`` / ``pmax`` and the port's
kernels (csrc/nanminmax.cuh) do: the library's float minimum and maximum
promise neither, so a float extremum is reduced as an integer key in the
float's total order (``order_key``), NaN as the key that wins, and a
minimum as the bitwise negation of its key, so that one MAX takes both.

Without a process group (a plain single-process run) every function
here is the identity of a world of one and issues no collective.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os
from typing import Optional

import torch
import torch.distributed as dist

from tmhpvsim_torch.config import slice_grid
from tmhpvsim_torch.engine.simulation import resolve_device
from tmhpvsim_torch.fleet.params import slice_fleet
from tmhpvsim_torch.obs import analytics as flt
from tmhpvsim_torch.obs import telemetry as tel_mod

#: seconds a rank waits for the others at the rendezvous and at each
#: collective before it raises (a rank that never arrives is an error,
#: not a hang)
DEFAULT_TIMEOUT_S = 600.0

#: the signed integer dtype of a float's bits, by the float's width
_KEY_DTYPE = {4: torch.int32, 8: torch.int64}


class CollectiveCounter:
    """How many ``all_reduce`` calls the wrappers issued and the bytes
    they reduced (plain integers)."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0


#: every ``all_reduce`` this module issues
ALL_REDUCE = CollectiveCounter()


def reset_counts() -> None:
    ALL_REDUCE.calls = 0
    ALL_REDUCE.bytes = 0


def world() -> tuple:
    """``(rank, world size)`` of the default group; ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _card_index(rank: int) -> int:
    """The card of rank ``rank``: ``LOCAL_RANK`` when a launcher exports
    it, else the rank modulo the cards of this host."""
    lr = os.environ.get("LOCAL_RANK")
    if lr is not None:
        return int(lr)
    return rank % max(1, torch.cuda.device_count())


def rank_device(device=None) -> torch.device:
    """The device of this rank, made the current CUDA device: ``None``
    and ``'cuda'`` mean the rank's card (``_card_index`` in a process
    group, the current device otherwise); the CPU stays the CPU.  The
    kernels launch on the current device's stream, so this is what binds
    them to the rank's card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", _card_index(world()[0]) if _grouped()
                           else torch.cuda.current_device())
    torch.cuda.set_device(dev)
    return dev


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the run's default process group; returns True when this call
    created it.

    ``coordinator`` is ``HOST:PORT`` (``tcp://`` rendezvous) or a URL
    ``torch.distributed`` takes (``tcp://...``, ``file:///...``), and
    comes with ``num_processes`` and ``process_id`` (the CLI's
    ``--coordinator``, ``--num-processes``, ``--process-id``).  Without
    them the environment a launcher exports (``torch.distributed.run``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) is used
    through ``env://``, and without that the run is a single process and
    nothing is done.  Nothing is done either when a default group
    exists.  The backend is NCCL for a CUDA device and gloo for the CPU;
    the rank's card becomes the current device first.  A rendezvous
    that fails or times out raises: a rank must never go on alone."""
    if _grouped():
        return False
    explicit = (coordinator, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("--coordinator, --num-processes and "
                             "--process-id go together")
        size, rank = int(num_processes), int(process_id)
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                       "WORLD_SIZE", "RANK")):
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        url = "env://"
    else:
        return False
    if size < 1 or not 0 <= rank < size:
        raise ValueError(f"process id {rank} outside [0, {size})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.device("cuda", _card_index(rank)))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    try:
        dist.init_process_group(backend, init_method=url, world_size=size,
                                rank=rank,
                                timeout=_dt.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"joining the {backend} process group at {url} as rank {rank} "
            f"of {size} failed: {e}") from e
    return True


def shutdown() -> None:
    """Leave the default process group (when there is one)."""
    if _grouped():
        dist.destroy_process_group()


def local_chain_slice(n_chains: int, rank: Optional[int] = None,
                      size: Optional[int] = None) -> slice:
    """The ``[start, stop)`` chains rank ``rank`` of ``size`` owns
    (default: this process in the default group): contiguous, equal
    shares in rank order."""
    if rank is None or size is None:
        rank, size = world()
    if n_chains % size:
        raise ValueError(f"n_chains={n_chains} must be divisible by the "
                         f"{size} processes")
    per = n_chains // size
    return slice(rank * per, (rank + 1) * per)


def chain_layout(n_chains: int, sharded: bool = False) -> dict:
    """Where a process's checkpoint file sits in the run
    (``meta['layout']``, engine/checkpoint.py): which global chains
    ``[chain_start, chain_stop)`` of ``n_chains`` it holds, the processes
    of the group and the cards of the run.  A plain run holds every chain
    on one card; a sharded one (``sharded``) holds its rank's share on one
    card a process.  Placement only, never identity: a resume under
    another layout reslices (``checkpoint.load_elastic``)."""
    rank, size = world()
    lay = {"n_chains": int(n_chains), "chain_start": 0,
           "chain_stop": int(n_chains), "process_count": size,
           "process_index": rank, "n_devices": 1}
    if sharded:
        lay.update(n_devices=size, mesh_shape=[size])
        if size > 1:
            sl = local_chain_slice(int(n_chains), rank, size)
            lay.update(chain_start=sl.start, chain_stop=sl.stop)
    return lay


def carve_config(config, offset: int, n: int, total=None):
    """Chain-range sub-view ``[offset, offset + n)`` of ``config`` (a
    config whose chain axis is resolved, ``engine.simulation.
    resolve_chains``): per-chain keys come from ``split(seed key,
    n_chains_total)`` sliced at the offset, and the site grid and fleet
    rows are sliced alike, so the sub-view's chains are the whole run's
    chains of that range."""
    total = config.n_chains if total is None else int(total)
    return dataclasses.replace(
        config, n_chains=int(n), n_chains_total=total,
        chain_offset=int(offset),
        site_grid=slice_grid(config.site_grid, offset, n),
        fleet=slice_fleet(config.fleet, offset, n))


def carve_process_config(config, rank: Optional[int] = None,
                         size: Optional[int] = None):
    """The sub-view of the chains rank ``rank`` of ``size`` owns (default:
    this process); a world of one returns ``config`` unchanged."""
    if rank is None or size is None:
        rank, size = world()
    if size == 1:
        return config
    sl = local_chain_slice(config.n_chains, rank, size)
    return carve_config(config, sl.start, sl.stop - sl.start,
                        total=config.n_chains)


def mesh_doc(n_chains: Optional[int] = None, rank: Optional[int] = None,
             size: Optional[int] = None) -> dict:
    """The run report's ``mesh`` section (the JAX package's schema v13):
    a one-axis ``chains`` mesh of one card per process, and the rank's
    chain range."""
    if rank is None or size is None:
        rank, size = world()
    doc = {"shape": [size], "axis_names": ["chains"], "n_devices": size,
           "process_count": size, "process_index": rank}
    if n_chains is not None:
        sl = local_chain_slice(int(n_chains), rank, size)
        doc.update(n_chains=int(n_chains),
                   chains_per_device=int(n_chains) // size,
                   chain_start=sl.start, chain_stop=sl.stop)
    return doc


# ---------------------------------------------------------------------------
# all_reduce of packed leaves
# ---------------------------------------------------------------------------

def order_key(x: torch.Tensor) -> torch.Tensor:
    """The float tensor ``x`` (32 or 64 bits) as signed integers in the
    float's total order: -inf < ... < -0.0 < +0.0 < ... < +inf (NaN is
    the caller's to place).  Its own inverse (``from_order_key``)."""
    k = x.view(_KEY_DTYPE[x.element_size()])
    mask = torch.iinfo(k.dtype).max
    return torch.where(k < 0, k ^ mask, k)


def from_order_key(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mask = torch.iinfo(k.dtype).max
    return torch.where(k < 0, k ^ mask, k).view(dtype)


def _all_reduce(t: torch.Tensor, op: str) -> None:
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    ALL_REDUCE.calls += 1
    ALL_REDUCE.bytes += t.numel() * t.element_size()


def _encode(flat: torch.Tensor, kind: str) -> torch.Tensor:
    """A packed group as the tensor its reduction runs on.  MIN and MAX
    both become MAX on integers: a float as its order key, NaN as the key
    that wins (the dtype's greatest), and a MIN leaf bitwise-negated
    (``~k`` reverses the order without overflow), so that one
    ``all_reduce`` takes the extrema of either kind."""
    if kind == "sum":
        return flat
    if flat.is_floating_point():
        info = torch.iinfo(_KEY_DTYPE[flat.element_size()])
        k = order_key(flat)
        if kind == "min":
            k = ~k
        return torch.where(torch.isnan(flat), info.max, k)
    return ~flat if kind == "min" else flat


def _decode(r: torch.Tensor, kind: str, dtype: torch.dtype) -> torch.Tensor:
    if kind == "sum":
        return r
    if not dtype.is_floating_point:
        return ~r if kind == "min" else r
    nan = r == torch.iinfo(r.dtype).max
    k = ~r if kind == "min" else r
    return torch.where(nan, torch.nan, from_order_key(k, dtype))


def allreduce_leaves(tree: dict, kinds: dict, device=None) -> dict:
    """``tree``'s leaves reduced over the default group, each by its kind
    (``kinds[name]``: 'sum', 'min' or 'max'): the sums of one dtype in one
    tensor, and the extrema of one width in one (``_encode``, once for
    each kind and dtype), each reduced by one ``all_reduce`` (on
    ``device`` when given), then decoded and split back (16-bit floats
    ride as float32, exactly).  Returns a new dict in ``tree``'s order,
    each leaf in its dtype, shape and device (``tree`` itself without a
    group)."""
    if not _grouped():
        return tree
    groups: dict = {}
    for name, v in tree.items():
        kind = kinds[name]
        dt = torch.float32 if v.is_floating_point() and \
            v.element_size() < 4 else v.dtype
        op = ("sum", dt) if kind == "sum" else (
            "max", _KEY_DTYPE[dt.itemsize] if dt.is_floating_point else dt)
        groups.setdefault(op, {}).setdefault((kind, dt), []).append(name)
    out = {}
    for (op, _), parts in groups.items():
        encoded = [_encode(torch.cat([tree[n].reshape(-1).to(dt)
                                      for n in names]), kind)
                   for (kind, dt), names in parts.items()]
        flat = torch.cat(encoded) if len(encoded) > 1 else encoded[0]
        if device is not None:
            flat = flat.to(device)
        _all_reduce(flat, op)
        o = 0
        for ((kind, dt), names), e in zip(parts.items(), encoded):
            dec = _decode(flat[o:o + e.numel()], kind, dt)
            o += e.numel()
            p = 0
            for n in names:
                v = tree[n]
                out[n] = dec[p:p + v.numel()].reshape(v.shape).to(
                    device=v.device, dtype=v.dtype)
                p += v.numel()
    return {name: out[name] for name in tree}


def allreduce_deltas(tel: Optional[dict], fleet: Optional[dict]) -> tuple:
    """A block's telemetry and analytics deltas over all ranks in one
    packed tree (``allreduce_leaves``), each leaf by its module's
    ``leaf_kinds`` (counters and sums summed, extrema the minimum /
    maximum): the JAX package's ``psum_telemetry`` and ``psum_fleet``.
    Either may be None."""
    tree, kinds = {}, {}
    for tag, delta, mod in (("t", tel, tel_mod), ("f", fleet, flt)):
        if delta is not None:
            for k, kind in mod.leaf_kinds(delta).items():
                tree[(tag, k)] = delta[k]
                kinds[(tag, k)] = kind
    if not tree:
        return tel, fleet
    out = allreduce_leaves(tree, kinds)
    return tuple(None if d is None else {k: out[(tag, k)] for k in d}
                 for tag, d in (("t", tel), ("f", fleet)))


def allreduce_sums(*parts: torch.Tensor) -> tuple:
    """Tensors of one dtype summed over all ranks in one ``all_reduce``
    (a block's per-second meter and pv sums)."""
    if not _grouped():
        return parts
    flat = torch.cat([p.reshape(-1) for p in parts])
    _all_reduce(flat, "sum")
    out, o = [], 0
    for p in parts:
        out.append(flat[o:o + p.numel()].reshape(p.shape))
        o += p.numel()
    return tuple(out)


def any_rank(flag: bool, device=None) -> bool:
    """True when ``flag`` is set on any rank of the default group: one
    ``all_reduce`` of one integer (on ``device`` under NCCL, on the CPU
    under gloo); ``flag`` itself without a group.  Every rank must call
    it."""
    if not _grouped():
        return flag
    dev = device if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    _all_reduce(t, "max")
    return bool(t.item())


def allreduce_stats(stats: dict, kinds: dict, device) -> dict:
    """Host aggregates (python floats and ints, ``kinds[name] = (kind,
    'f' | 'i')`` as ``engine.simulation.REDUCE_STATS``) over all ranks,
    as float64 / int64 tensors on ``device``; returns python numbers."""
    if not _grouped():
        return stats
    tree = {k: torch.tensor(v, dtype=torch.int64 if kinds[k][1] == "i"
                            else torch.float64)
            for k, v in stats.items()}
    out = allreduce_leaves(tree, {k: kinds[k][0] for k in tree}, device)
    return {k: (int if kinds[k][1] == "i" else float)(v.item())
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

def gather_metrics(snapshot: dict) -> list:
    """Every rank's metrics snapshot, in rank order (the run report's
    ``processes`` section); a world of one returns ``[snapshot]``
    without a collective.  Every rank must call it."""
    rank, size = world()
    if size == 1:
        return [snapshot]
    out = [None] * size
    dist.all_gather_object(out, snapshot)
    return out
