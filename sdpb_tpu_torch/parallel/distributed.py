"""Runs of several processes over torch.distributed (the port's counterpart
of sdpb_tpu/parallel/distributed.py).

The reference spreads its blocks over MPI ranks (allocate_blocks.cxx:37-117)
and reduces Q across them (synchronize_Q.cxx:23-186).  The JAX package
runs one SPMD program over a `blocks` mesh axis; the port runs one
process per rank, each on its own shard of every bucket's batch
(parallel/mesh.py), with the iteration's reductions as all-gathers
(solver/step.py).

`initialize` joins the ranks: from the CLI's --coordinator/--numProcesses/
--processId, else from torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
and LOCAL_RANK.  The coordinator is host:port (a TCP rendezvous that rank 0
serves) or file:///path (a file rendezvous, no port).  The default process
group is always gloo: host objects, the gathers of checkpoints and
solutions, host decisions.  The solver's collectives go over NCCL when
each rank has a card of its own (graph-capturable), else over that gloo
group: on the CPU, and for ranks that share one card, whose CUDA tensors
then go through the host in Group.all_gather.  No path switches backend
after a failure, and every collective has a finite timeout, so a rank
stuck in one fails the run instead of stalling it.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 600.0
# seconds a rank may wait in Group.share for rank 0's host work, longest
# its timing run (parallel/timing.py::timing_run_broadcast)
SHARE_TIMEOUT_S = 7200.0


@dataclass
class Group:
    """This process's place in the run (its rank, the world size, whether
    it coordinates, its device) and the process groups it uses."""
    rank: int
    world_size: int
    device: torch.device      # the rank's device
    backend: str              # of the solver's collectives: "nccl" or "gloo"
    pg: object                # their process group
    store: object             # the rendezvous store (share)
    _shared: int = field(default=0, repr=False)

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t stacked on a new leading axis, in rank order: the
        one collective of the solver.  On gloo a CUDA tensor goes through
        a host copy, the one place where the solver's data leaves the
        card."""
        if self.backend == "gloo":
            host = t.detach().cpu().contiguous()
            out = torch.empty((self.world_size,) + tuple(host.shape), dtype=host.dtype)
            dist.all_gather(list(out.unbind(0)), host, group=self.pg)
            return out.to(t.device)
        out = torch.empty((self.world_size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.pg)
        return out

    def agree(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any: a decision each
        rank makes on its own clock (a checkpoint's time, maxRuntime)
        taken once for all, so that no rank leaves the others' sequence of
        collectives."""
        t = torch.tensor([float(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def sum_int(self, n: int) -> int:
        t = torch.tensor([n], dtype=torch.int64)
        dist.all_reduce(t)
        return int(t.item())

    def share(self, payload: Optional[str]) -> str:
        """Rank 0's payload on every rank, through the store: the others
        wait in the store's blocking get, up to SHARE_TIMEOUT_S, longer
        than a collective would, while rank 0 works (a timing run)."""
        key = f"sdpb_tpu_torch/share/{self._shared}"
        self._shared += 1
        if self.is_coordinator:
            self.store.set(key, payload)
            return payload
        self.store.wait([key], timedelta(seconds=SHARE_TIMEOUT_S))
        return self.store.get(key).decode()

    def warm(self) -> None:
        """One collective on the rank's device now, so that the NCCL
        communicator exists before a CUDA graph capture records any."""
        self.all_gather(torch.zeros(1, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Leave the run: every process group of this process."""
        if dist.is_initialized():
            dist.destroy_process_group()


def _store(coordinator: str, world_size: int, rank: int, timeout: timedelta):
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], world_size)
    host, _, port = coordinator.removeprefix("tcp://").rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--coordinator {coordinator}: expected host:port or file:///path")
    # under torchrun the agent already serves the store at MASTER_PORT
    serve = rank == 0 and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    return dist.TCPStore(host, int(port), world_size, is_master=serve, timeout=timeout)


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S, verbosity: int = 1) -> Optional[Group]:
    """Join the run's process groups; None when no run of several
    processes is asked for (no coordinator, world size or rank given, and
    none in the environment).  `device` is the run's device: the CPU, a
    card named by index, or "cuda", which takes the card of the rank's
    local rank (LOCAL_RANK, else process_id modulo the host's cards: ranks
    numbered host by host)."""
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = {"--coordinator": coordinator, "--numProcesses": num_processes,
             "--processId": process_id}
    if all(v is None for v in given.values()):
        return None
    missing = [k for k, v in given.items() if v is None]
    if missing:
        raise SystemExit(f"a run of several processes needs {', '.join(missing)} too "
                         f"(or torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK)")
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--processId {process_id} is not in [0, {num_processes})")
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        if device.index is None:
            local = int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env else \
                process_id % torch.cuda.device_count()
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=timeout_s)
    store = _store(coordinator, num_processes, process_id, timeout)
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    places = [None] * num_processes
    dist.all_gather_object(places, (socket.gethostname(), str(device)))
    if device.type == "cuda" and len(set(places)) == num_processes:
        backend, why = "nccl", "each rank has a card of its own"
        pg = dist.new_group(backend="nccl", timeout=timeout)
    else:
        backend, pg = "gloo", dist.group.WORLD
        why = "CPU tensors" if device.type == "cpu" else \
            "ranks share a card: its tensors go through the host, host loop only"
    if verbosity >= 1 and process_id == 0:
        print(f"process group   : {num_processes} ranks, collectives over {backend} ({why})")
    return Group(rank=process_id, world_size=num_processes, device=device, backend=backend,
                 pg=pg, store=store)

