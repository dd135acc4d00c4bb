"""Start ``n`` ranks of ``torch.distributed`` and run one function in each.

The port's counterpart of the JAX package's self-provisioning
(``examples/planar_sharded.py _ensure_devices``, ``__graft_entry__.py
dryrun_multichip``): where JAX re-runs itself on a mesh of virtual CPU
devices, the port starts one process per rank.

- Processes start with the ``spawn`` method, never ``fork`` (the caller may
  hold CUDA or JAX state), and meet on a ``file://`` rendezvous in a fresh
  temporary directory, so concurrent callers never share a port.
- Backend: NCCL when the ranks run on CUDA and each has a card of its own,
  gloo otherwise (on the CPU, and for several ranks sharing one card:
  NCCL refuses two ranks on one device). The choice is printed.
- The CUDA kernels are built in the calling process before the ranks start,
  so the ranks load the built libraries and never run ``nvcc`` at once.
- A failure in any rank fails the call: the ranks are joined against a
  deadline, and on an error or at the deadline every rank is killed and
  the call raises. The process groups carry the same timeout, so a rank
  waiting on a collective of a dead peer does not wait longer.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback


def choose_backend(world_size: int, device: str) -> str:
    """``"nccl"`` when the ranks run on CUDA with a card each, else
    ``"gloo"``."""
    import torch

    if device == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def launch(fn, world_size: int, args=(), *, device: str = "cuda", timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in each of ``world_size`` ranks and return their
    results, rank 0 first. ``fn`` must be importable by name (a module-level
    function) and its arguments and result picklable. ``device``: ``"cuda"``
    (rank ``r`` on card ``r % count``) or ``"cpu"``. ``timeout``: seconds
    for the whole call and for each collective. A CPU rank computes on one
    thread (ranks that share the host's cores would otherwise oversubscribe
    them); a CUDA rank gets its share of the host's cores."""
    import torch

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        from stoch_gpmp_tpu_torch.ops.kernels import _build

        _build.load_library()  # built once here; the ranks load the cached libraries
    backend = choose_backend(world_size, device)
    threads = 1 if device == "cpu" else max(1, (os.cpu_count() or 1) // world_size)
    print(f"parallel.launch: {world_size} ranks on {device}, backend {backend}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="stoch_gpmp_ranks_")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world_size, init, backend, device, timeout, threads, fn,
                               tuple(args), results))
             for rank in range(world_size)]
    deadline = time.monotonic() + timeout
    out, errors = {}, []
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"deadline of {timeout:.0f} s passed with ranks "
                              f"{sorted(set(range(world_size)) - set(out))} unfinished")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    time.sleep(0.5)  # a last message may still be in the pipe
                    if results.empty():
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]}")
                        break
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("parallel.launch failed: " + "\n".join(errors))
    return [out[r] for r in range(world_size)]


def _rank_main(rank, world_size, init, backend, device, timeout, threads, fn, args, results):
    """One rank: join the process group, run ``fn(*args)``, report the
    result or the traceback, leave the group."""
    import torch
    import torch.distributed as dist

    try:
        torch.set_num_threads(threads)
        kw = {}
        if device == "cuda":
            card = rank % torch.cuda.device_count()
            torch.cuda.set_device(card)
            if backend == "nccl":
                kw["device_id"] = torch.device("cuda", card)
        dist.init_process_group(backend, init_method=init, world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout), **kw)
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the caller raises it
        raise
