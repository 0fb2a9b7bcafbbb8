"""Start a process group on one host without torchrun, for the tests of
data parallelism (``tests/test_torch_parallel.py``).

:func:`spawn` starts ``world`` processes (the ``spawn`` start method), each
with torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set, joins them
into one group over a ``FileStore`` at ``store`` (a path that does not
exist yet; no TCP port), calls ``fn(rank, *args)`` and tears the group
down.  ``fn`` must be importable by name.  A rank's exception fails the
call with that rank's traceback (``torch.multiprocessing``), and the other
ranks are stopped; so are all of them past a timeout.
"""

import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, store, backend, threads, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, store: str, args=(), backend: str = "gloo",
          threads: int = 0, join: bool = True, timeout: float = 600.0):
    """Run ``fn(rank, *args)`` on ranks 0..world-1 (module note);
    ``threads`` > 0 sets each process's torch thread count.  With ``join``
    the call returns when every rank has (:func:`wait`); without it, it
    returns the ``ProcessContext`` for :func:`wait`."""
    ctx = mp.start_processes(
        _entry, args=(fn, world, store, backend, threads, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    if join:
        wait(ctx, timeout)
    return ctx


def wait(ctx, timeout: float = 600.0) -> None:
    """Wait for the processes of ``spawn(..., join=False)``: a rank's
    exception is raised here; past ``timeout`` seconds every process is
    stopped and TimeoutError raised."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"ranks still running after {timeout} s")
