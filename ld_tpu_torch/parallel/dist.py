"""Data parallelism over processes: the 'data' axis of
`ld_tpu/parallel/mesh.py` on `torch.distributed`.

The JAX package runs one program over a mesh of every device, and every
sum in its objective is a sum over the global batch. Here each rank is a
process with b images of an R x b global batch; a rank reaches the global
values through these collectives:

  * `global_sum(t)`: a detached all-reduce SUM, for the batch-wide counts
    that normalise the losses (positives, quality weights, imitation
    masks); `global_mean(t)` is a 'mean' over the global batch;
  * `all_gather(t)`: the ranks' tensors concatenated in rank order, for the
    GI region's candidates, which JAX pools over the global batch;
  * `all_reduce_mean(dict)` for logged metrics, `all_reduce_host` for
    host numbers every rank must act on together (a SIGTERM flag, a pad
    shape, an image count), `broadcast_object` and
    `all_gather_object` for host values (metrics, eval results).

Each of them is the identity when no process group is up, so one-process
code runs them unchanged. `init_dist` starts the group from torchrun's
environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`) on `cuda:{LOCAL_RANK %
device_count}`. The configs' `dist_params = dict(backend='xla')` reads as
the device's collective: NCCL on cards, gloo on the CPU. NCCL refuses two
ranks on one card; asking for it there raises.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _world() -> int:
    return get_dist_info()[1]


def resolve_backend(backend: Optional[str], device_type: str,
                    local_world_size: int, device_count: int) -> str:
    """The process group's backend for `backend` as a config names it:
    None or 'xla' is the device's collective (NCCL for 'cuda', gloo for
    'cpu'); 'nccl' and 'gloo' are taken as written. NCCL raises on the CPU,
    and where this host's ranks outnumber its cards."""
    if backend in (None, 'xla'):
        backend = 'nccl' if device_type == 'cuda' else 'gloo'
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f'dist backend {backend!r}: nccl, gloo or xla')
    if backend == 'nccl':
        if device_type != 'cuda':
            raise ValueError('the nccl backend needs the card; on the CPU '
                             'use --cfg-options dist_params.backend=gloo')
        if local_world_size > device_count:
            raise RuntimeError(
                f'{local_world_size} ranks on {device_count} card(s): NCCL '
                'refuses two ranks on one card ("Duplicate GPU detected"). '
                'Run one rank a card, or share the card over gloo with '
                '--cfg-options dist_params.backend=gloo')
    return backend


def init_dist(launcher: str = 'pytorch', backend: Optional[str] = None,
              init_method: Optional[str] = None,
              device=None) -> torch.device:
    """Join the process group of a torchrun launch (or of `init_method`,
    e.g. 'file:///path' or 'tcp://localhost:port', with the rank and world
    size from `RANK` / `WORLD_SIZE`); returns this rank's device:
    `cuda:{LOCAL_RANK % device_count}` (made current), or the CPU with
    device='cpu'. A group already up is kept."""
    if launcher != 'pytorch':
        raise ValueError(f"launcher {launcher!r}: only 'pytorch' (torchrun) "
                         'is supported')
    if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
        raise RuntimeError("launcher 'pytorch' reads RANK and WORLD_SIZE: "
                           'start the program with python -m '
                           'torch.distributed.run')
    rank = int(os.environ['RANK'])
    world = int(os.environ['WORLD_SIZE'])
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    device = torch.device('cuda' if device is None else device)
    count = 0
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               'run on the CPU')
        count = torch.cuda.device_count()
        device = torch.device('cuda', local_rank % count)
        torch.cuda.set_device(device)
    backend = resolve_backend(backend, device.type, local_world, count)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or 'env://',
                                rank=rank, world_size=world)
    return device


def barrier():
    if _world() > 1:
        dist.barrier()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, detached (`t` itself without a
    group): a count that normalises a loss is a count over the global
    batch."""
    if _world() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `t` on every rank: sum over the global
    element count (the gradient reaches this rank's elements)."""
    if _world() == 1:
        return t.mean()
    return t.sum() / global_sum(torch.tensor(float(t.numel()),
                                             device=t.device))


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The ranks' `t` (equal shapes) concatenated along dim 0 in rank
    order; no gradient."""
    world = _world()
    if world == 1:
        return t
    # gloo gathers host tensors only
    host = dist.get_backend() == 'gloo' and t.is_cuda
    src = t.detach().cpu() if host else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def _host_device() -> torch.device:
    """Where a collective of host values runs: NCCL takes card tensors."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_host(values: List[float], op: str = 'sum') -> List[float]:
    """The element-wise sum (or 'max') over the ranks of a few host
    numbers."""
    if _world() == 1:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=_host_device())
    dist.all_reduce(t, op=dict(sum=dist.ReduceOp.SUM,
                               max=dist.ReduceOp.MAX)[op])
    return t.tolist()


def all_reduce_mean(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each scalar of `metrics` averaged over the ranks, in one collective
    (detached)."""
    world = _world()
    if world == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    t = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(t)
    t /= world
    return dict(zip(keys, t.unbind()))


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (a picklable host value)."""
    if _world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=_host_device())
    return box[0]


def all_gather_object(obj) -> List:
    """Every rank's `obj`, in rank order."""
    world = _world()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out
