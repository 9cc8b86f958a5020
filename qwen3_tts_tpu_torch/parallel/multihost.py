"""The distributed world and the multi-host serving layout. Twin of
qwen3_tts_tpu/parallel/multihost.py, on torch.distributed.

- ``init_distributed()``: one process per device joins the world from
  arguments or the QWEN3_TTS_* environment (a no-op for one process). The
  store is the rendezvous: ``host:port`` (rank 0 serves a TCP store
  there, as JAX's coordinator) or ``file:///path`` (a file store, for
  ranks on one machine). Each rank leaves its host name and device in
  the store, which is how ``make_serving_mesh`` knows the hosts.
- ``make_serving_mesh(tp)``: a dp x tp mesh whose tp groups never cross
  a host (tp collectives run every layer), laid out host-major, so a dp
  group's slots (and, paged, its page sub-pool) live on one host.
- ``host_slot_range``: the contiguous slot block of a rank's dp group.
- ``barrier`` / ``shutdown_distributed``: a store barrier (not a device
  collective) and the teardown.
- ``spawn_ranks``: start the n ranks of one machine as processes of a
  command and wait for them (the CLI's ``--tp N``, the batched daemon's
  ``--tp``/``--dp``, chip_smoke.py, the tests' rank workers).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from qwen3_tts_tpu_torch.parallel.mesh import (DP, Mesh, RankDevice,
                                               as_rank_devices,
                                               mesh_from_grid)

_KEY = "qwen3_tts/"


@dataclasses.dataclass
class _World:
    store: object
    devices: list


# this process's world once init_distributed joined one (the process
# group itself is process-wide state of torch.distributed too)
_world: Optional[_World] = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_devices() -> list:
    """Every rank's RankDevice: the world's, or this process alone on
    ``cuda:0`` when it joined none."""
    if _world is not None:
        return list(_world.devices)
    return [RankDevice(0, "cuda:0", socket.gethostname())]


def default_device(rank: int) -> str:
    """``cuda:local_rank``: LOCAL_RANK when a launcher set it, else the
    rank modulo this host's cards. There is no CPU fallback."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        local = rank % max(n, 1)
    return f"cuda:{int(local)}"


def _store(coordinator: str, n: int, rank: int, timeout: timedelta):
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], n)
    addr = coordinator.split("://", 1)[-1]
    host, port = addr.rsplit(":", 1)
    return dist.TCPStore(host, int(port), n, rank == 0, timeout=timeout)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> bool:
    """Join the world from arguments or QWEN3_TTS_COORDINATOR,
    QWEN3_TTS_NUM_PROCESSES and QWEN3_TTS_PROCESS_ID. Returns False for
    one process (nothing is touched then), True once joined.

    ``device``: this rank's device (default_device by default).
    ``backend``: "gloo" on a CPU device; on a CUDA device NCCL for CUDA
    tensors and gloo for the host tensors the batcher gathers (two ranks
    sharing one card need "gloo": NCCL refuses a duplicate GPU). The
    timeout of the rendezvous and of every collective is
    QWEN3_TTS_DIST_INIT_TIMEOUT seconds (900 by default)."""
    global _world
    coordinator = coordinator or os.environ.get("QWEN3_TTS_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("QWEN3_TTS_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("QWEN3_TTS_PROCESS_ID", "0"))
    if num_processes <= 1:
        return False
    if not coordinator:
        # returning False would start this process alone while its peers
        # wait for it at the rendezvous
        raise ValueError(
            f"QWEN3_TTS_NUM_PROCESSES={num_processes} but no coordinator "
            "address: set QWEN3_TTS_COORDINATOR=host:port (or pass "
            "coordinator=)")
    if _world is not None:
        return True
    timeout = timedelta(seconds=int(
        os.environ.get("QWEN3_TTS_DIST_INIT_TIMEOUT", "900")))
    device = str(torch.device(device or default_device(process_id)))
    on_cuda = device.startswith("cuda")
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if on_cuda else "gloo"
    if on_cuda:
        torch.cuda.set_device(torch.device(device))
    store = _store(coordinator, num_processes, process_id, timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    store.set(f"{_KEY}rank/{process_id}",
              f"{socket.gethostname()}\n{device}")
    devices = []
    for r in range(num_processes):
        host, dev = store.get(f"{_KEY}rank/{r}").decode().split("\n")
        devices.append(RankDevice(r, dev, host))
    _world = _World(store, devices)
    return True


def barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """Block until every rank reaches the barrier ``name`` (a store
    counter, not a device collective, so phases of very different length
    can be fenced). ``timeout_s``: QWEN3_TTS_DIST_SHUTDOWN_TIMEOUT
    seconds (900) by default. A no-op for one process; each name is used
    once."""
    if _world is None:
        return
    if timeout_s is None:
        timeout_s = float(os.environ.get("QWEN3_TTS_DIST_SHUTDOWN_TIMEOUT",
                                         "900"))
    key = f"{_KEY}barrier/{name}"
    if _world.store.add(key, 1) == len(_world.devices):
        _world.store.set(key + "/done", "1")
    _world.store.wait([key + "/done"], timedelta(seconds=timeout_s))


def shutdown_distributed() -> None:
    """Leave the world (idempotent; a no-op for one process). A clean
    exit passes a final barrier() first; a failing rank calls this at
    once, so that its peers' collectives fail instead of waiting out
    their timeout."""
    global _world
    if dist.is_initialized():
        dist.destroy_process_group()
    _world = None


def make_serving_mesh(tp: int, devices: Optional[Sequence] = None,
                      dp: Optional[int] = None) -> Mesh:
    """A dp x tp mesh whose tp groups never cross a host. Ranks are
    grouped by host and laid out host-major (hosts in the order of their
    first rank): with H hosts of D ranks the mesh is (H * D // tp, tp)
    and rows [h*D//tp, (h+1)*D//tp) belong to host h. ``dp`` caps the dp
    extent; every rank must keep a place in the mesh."""
    devs = as_rank_devices(devices)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    need = tp * (dp or 1)
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    by_host = {}
    for d in sorted(devs, key=lambda d: d.rank):
        by_host.setdefault(d.host, []).append(d)
    ordered = []
    for host, local in by_host.items():
        if len(local) % tp:
            raise ValueError(
                f"host {host!r} has {len(local)} devices, not divisible "
                f"by tp={tp} — tp groups must not cross hosts")
        ordered.extend(local)
    total_dp = len(ordered) // tp
    if dp is not None:
        if dp > total_dp:
            raise ValueError(f"dp={dp} needs {dp * tp} devices, "
                             f"have {len(ordered)}")
        total_dp = dp
    chosen = ordered[:total_dp * tp]
    # a rank left out of the mesh would never join its collectives
    stranded = sorted({d.rank for d in devs} - {d.rank for d in chosen})
    if stranded:
        raise ValueError(
            f"dp={total_dp} x tp={tp} uses only the first "
            f"{total_dp * tp} devices and leaves rank(s) {stranded} "
            "with no mesh position — lower tp/dp or start fewer ranks")
    grid = np.empty((total_dp, tp), dtype=object)
    for i, d in enumerate(chosen):
        grid[i // tp, i % tp] = d
    return mesh_from_grid(grid)


def host_slot_range(mesh: Mesh, batch_size: int,
                    process_index: Optional[int] = None):
    """The contiguous [lo, hi) slot block of ``process_index``'s dp group
    (this rank by default) under the batch-over-dp split: the slots whose
    KV and, paged, pages that rank holds. (0, 0) for a rank outside the
    mesh."""
    if process_index is None:
        process_index = mesh.rank
    dp_size = mesh.shape[DP]
    if batch_size % dp_size:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"dp {dp_size}")
    per = batch_size // dp_size
    for i in range(dp_size):
        if any(d.rank == process_index for d in mesh.devices[i]):
            return (i * per, (i + 1) * per)
    return (0, 0)


@dataclasses.dataclass
class RankExit:
    """How one rank of spawn_ranks ended: its exit code (negative: killed
    by that signal) and the end of its output ("" where it kept this
    process's)."""

    rank: int
    code: int
    log: str


def spawn_ranks(argv: Sequence[str], n: int, store_dir: str,
                timeout: Optional[float] = None, env: Optional[dict] = None,
                keep_rank0_output: bool = False,
                on_start: Optional[Callable[[list], None]] = None
                ) -> List[RankExit]:
    """Run the command ``argv`` as the n ranks of a world on this machine:
    rank r gets QWEN3_TTS_NUM_PROCESSES=n, QWEN3_TTS_PROCESS_ID=r and a
    file store in ``store_dir`` (so no TCP port can clash), over this
    process's environment and ``env``. Rank r writes its output to
    ``store_dir``/log<r>.txt (its last 4000 characters come back); with
    ``keep_rank0_output`` rank 0 writes to this process's standard output
    and error instead. ``on_start`` is called with the ranks' Popen
    objects once all have started (to signal them: the batched daemon
    passes its SIGTERM on to rank 0). The first rank that fails ends the
    others. Past
    ``timeout`` seconds every rank is ended and TimeoutError raised with
    the ranks' output; a timeout also bounds each rank's rendezvous and
    collectives (QWEN3_TTS_DIST_INIT_TIMEOUT, unless given). Returns each
    rank's RankExit in rank order."""
    base = dict(os.environ, **(env or {}),
                QWEN3_TTS_NUM_PROCESSES=str(n),
                QWEN3_TTS_COORDINATOR="file://" + os.path.join(store_dir,
                                                               "store"))
    if timeout is not None and "QWEN3_TTS_DIST_INIT_TIMEOUT" not in (
            env or {}):
        base["QWEN3_TTS_DIST_INIT_TIMEOUT"] = str(int(timeout))
    logs = [None if keep_rank0_output and r == 0 else
            open(os.path.join(store_dir, f"log{r}.txt"), "w+")
            for r in range(n)]
    procs = []
    timed_out = False
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                list(argv), env=dict(base, QWEN3_TTS_PROCESS_ID=str(r)),
                stdout=logs[r],
                stderr=None if logs[r] is None else subprocess.STDOUT))
        if on_start is not None:
            on_start(procs)
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        out = []
        for r, f in enumerate(logs):
            text = ""
            if f is not None:
                f.seek(0)
                text = f.read()[-4000:]
                f.close()
            if r < len(procs):
                out.append(RankExit(r, procs[r].returncode, text))
    if timed_out:
        raise TimeoutError(
            f"{n} ranks of {' '.join(argv[:3])} still running after "
            f"{timeout} s:\n" + format_exits(out))
    return out


def run_own_ranks(module: str, argv: Sequence[str], n: int, label: str,
                  timeout: Optional[float] = None,
                  on_start: Optional[Callable[[list], None]] = None) -> int:
    """Run ``python -m module argv`` as the n ranks of a world on this
    machine, its file store in a temporary directory (spawn_ranks), with
    this checkout on PYTHONPATH and this host's cores split among the
    ranks; rank 0 keeps this process's output. A failing rank ends the
    others; the output of every rank that did not exit 0 goes to stderr
    under ``label``. Returns the failing rank's exit code (1 on a timeout
    or a signal), else 0. The launcher of the CLI's ``--tp N`` and of the
    batched daemon's ``--tp``/``--dp``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = {"PYTHONPATH": root + (os.pathsep + path if path else ""),
           "OMP_NUM_THREADS": os.environ.get(
               "OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))}
    with tempfile.TemporaryDirectory(prefix="qwen3_tts_ranks_") as d:
        try:
            exits = spawn_ranks([sys.executable, "-m", module, *argv], n, d,
                                timeout=timeout, env=env,
                                keep_rank0_output=True, on_start=on_start)
        except TimeoutError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    failed = [e for e in exits if e.code]
    if not failed:
        return 0
    # the ranks this process ended exit on a signal (a negative code)
    first = next((e for e in failed if e.code > 0), failed[0])
    print(f"error: {label}: rank {first.rank} exited {first.code}\n"
          + format_exits(failed), file=sys.stderr)
    return first.code if first.code > 0 else 1


def format_exits(exits: Sequence[RankExit]) -> str:
    """The ranks' exit codes and output, for an error message."""
    return "\n".join(f"--- rank {e.rank} (exit {e.code}):\n{e.log}"
                     for e in exits)
