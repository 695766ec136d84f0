"""Multi-process initialization on ``torch.distributed`` (counterpart of
:mod:`psa_tpu.parallel.distributed`).

The JAX package initializes ``jax.distributed``; here a process group joins
the processes of a run.  Nothing on a GPU machine tells a program of its
cluster: the coordinator, the world size and the rank come from the
arguments, or else from torchrun's variables (``MASTER_ADDR``/
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       backend: Optional[str] = None,
                       device: str = 'cuda'):
    """Join this process to the run's default process group; returns it.

    Args:
        coordinator_address: 'host:port' of rank 0 (``tcp://`` may be
            given); default ``MASTER_ADDR:MASTER_PORT``.
        num_processes: world size; default ``WORLD_SIZE``.
        process_id: this process's rank; default ``RANK``.
        backend: 'nccl' or 'gloo'; None picks 'nccl' when the process's
            device is CUDA and 'gloo' on the CPU.  NCCL takes one rank per
            card; two ranks on one card need 'gloo'.
        device: the process's device type, 'cuda' or 'cpu' (for ``backend``).
    """
    coordinator = coordinator_address
    if coordinator is None and os.environ.get('MASTER_ADDR'):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator is None:
        raise ValueError("initialize_cluster needs coordinator_address or MASTER_ADDR")
    if num_processes is None:
        num_processes = int(os.environ['WORLD_SIZE'])
    if process_id is None:
        process_id = int(os.environ['RANK'])
    if backend is None:
        backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    url = coordinator if '://' in coordinator else f'tcp://{coordinator}'
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))
    logger.info("torch.distributed initialized (%s): process %d/%d", backend,
                dist.get_rank(), dist.get_world_size())
    return dist.group.WORLD


def global_mesh_info() -> dict:
    """Device and topology summary for logs and manifests, under the JAX
    package's keys."""
    ready = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if ready else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        'process_index': dist.get_rank() if ready else 0,
        'process_count': world,
        'local_devices': local,
        'global_devices': local * world,
        'platform': 'gpu' if torch.cuda.is_available() else 'cpu',
    }
