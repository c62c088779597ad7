"""Multi-process learners: the join of a `torch.distributed` world.

Counterpart of the JAX package's `parallel/distributed.py`. The data
plane (actor <-> learner trajectories and weights) stays the socket
transport of `runtime/transport.py`; this module joins the compute
plane, the learner processes that run one learn step together
(`parallel/learner.py:ShardedLearner` over `parallel/mesh.py`'s mesh of
ranks). `runtime/transport.run_role --mode learner` calls it; each
process then takes `batch_size / world` rows from its own data plane.

One rank is one process on one device: `cuda:{process_id % count}` on
a CUDA host (the caller's device index wins where it names one), the
CPU where the caller asks for it. JAX's processes may own several
devices each; a host with several GPUs runs several ranks.

The env contract is the JAX package's, with no name added:
    DRL_COORDINATOR=host0:9900  DRL_NUM_PROCESSES=4  DRL_PROCESS_ID=0
Rank 0 serves the rendezvous store (`torch.distributed.TCPStore`) at
the coordinator's address. Before the group is made each rank writes
its host and device to the store, and every rank applies one rule to
what all of them wrote: NCCL when every rank is on CUDA and no two
share a (host, GPU) pair, else gloo (the CPU; and ranks that share a
GPU, where NCCL refuses two ranks on one device). Each rank prints the
backend it chose. The rule is not a fallback: a failed
`init_process_group` raises, and nothing moves to the CPU.

    from distributed_reinforcement_learning_tpu_torch.parallel import distributed
    distributed.initialize()          # env-driven, a no-op on one process
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device

# Seconds a rank waits for the others at the rendezvous and in a collective.
TIMEOUT_S = 300

_device: torch.device | None = None
_backend: str | None = None


def is_initialized() -> bool:
    return _device is not None


def requested() -> bool:
    """Whether the env asks for a multi-process learner group (what
    `initialize()` would join), without joining it."""
    return bool(os.environ.get("DRL_COORDINATOR", "").strip()
                or os.environ.get("DRL_NUM_PROCESSES", "").strip())


def _device_key(dev: torch.device) -> str:
    """What makes two ranks' devices the same device: the host and, on
    CUDA, the GPU's UUID (two processes may see one GPU under different
    indices)."""
    host = socket.gethostname()
    if dev.type != "cuda":
        return f"{host}/cpu"
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return f"{host}/cuda/{uuid if uuid is not None else dev.index}"


def choose_backend(keys: list[str]) -> str:
    """The backend rule over every rank's `_device_key`: NCCL when all
    are CUDA devices and no two are the same device, else gloo."""
    on_cuda = all("/cuda/" in k for k in keys)
    return "nccl" if on_cuda and len(set(keys)) == len(keys) else "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device: str | torch.device | None = None) -> bool:
    """Join the multi-process learner group; -> True if a join happened.

    Explicit arguments win over the `DRL_*` env names. With neither the
    coordinator nor the process count this is a single-process no-op
    (False), so launchers may call it unconditionally. A second call does
    nothing. `backend` overrides the rule; `device` is the device the
    caller runs on (CUDA unless it names another)."""
    global _device, _backend
    if _device is not None:
        return True
    coordinator_address = coordinator_address or os.environ.get("DRL_COORDINATOR")
    if num_processes is None and "DRL_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DRL_NUM_PROCESSES"])
    if process_id is None and "DRL_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DRL_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process learner needs DRL_COORDINATOR, DRL_NUM_PROCESSES "
                         "and DRL_PROCESS_ID (or the three arguments)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"DRL_PROCESS_ID {process_id} outside 0..{num_processes - 1}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout)
    store.set(f"drl/device/{process_id}", _device_key(dev))
    keys = [store.get(f"drl/device/{r}").decode() for r in range(num_processes)]
    chosen = backend or choose_backend(keys)
    why = "override" if backend else (
        "every rank on its own GPU" if chosen == "nccl"
        else "ranks share a GPU" if all("/cuda/" in k for k in keys) else "CPU ranks")
    print(f"[distributed] rank {process_id}/{num_processes}: backend {chosen} on {dev} ({why})",
          flush=True)
    dist.init_process_group(chosen, store=store, rank=process_id, world_size=num_processes,
                            timeout=timeout,
                            **({"device_id": dev} if chosen == "nccl" else {}))
    _device, _backend = dev, chosen
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) on a single process."""
    if _device is None:
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def device() -> torch.device | None:
    """This rank's device (None before a join)."""
    return _device


def backend() -> str | None:
    """The backend the rule chose (None before a join)."""
    return _backend


def shutdown() -> None:
    """Leave the group (a no-op without a join)."""
    global _device, _backend
    if _device is not None:
        dist.destroy_process_group()
        _device = _backend = None
