"""Start the ranks of a ``torch.distributed`` job on one host.

JAX runs its mesh inside one process, so the JAX package has no counterpart
of this module.  :func:`run` spawns ``world_size`` processes (the spawn
start method), joins them into one default process group through a
``file://`` rendezvous in a temporary directory (no TCP port, so parallel
test workers cannot collide), runs a module-level function in each and
returns every rank's result to the caller:

    from autourdf_tpu_torch.parallel import launch
    results = launch.run(my_module.rank_fn, 4, args=(...,), device="cpu")

Backend: gloo on the CPU, and for CUDA when there are more ranks than cards
(several ranks on one card; NCCL refuses two ranks on one device); NCCL when
every rank has a card of its own.  A rank that raises makes :func:`run`
raise with the tracebacks of every rank that failed; the other ranks are
terminated.
"""

from __future__ import annotations

import datetime
import glob
import os
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .sharding import _tree_map


def backend_for(device: str, world_size: int) -> str:
    """gloo on the CPU or with more ranks than cards, else NCCL."""
    if device == "cpu" or world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _rank_main(rank, fn, args, world_size, backend, device, tmp, timeout_s):
    os.environ["LOCAL_RANK"] = str(rank)
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        torch.save(_tree_map(lambda t: t.detach().cpu(), result),
                   os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        # the first rank to fail is often not the first that torch reports
        # (the others then fail in a collective): keep every rank's cause
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run(fn, world_size: int, args: tuple = (), device: str = "cuda",
        timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks; returns their results in
    rank order, tensors moved to the CPU.

    ``fn`` must be importable by name (a module-level function) and is
    called after the default process group is up; it finds its rank with
    ``torch.distributed.get_rank()``.  ``device`` "cuda" builds the kernel
    library here, once, before the ranks start (each would otherwise run
    its own nvcc); "cpu" runs every rank on one intra-op thread.
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the ranks on the CPU")
        from ..ops import _cuda

        _cuda.build("knn")
    backend = backend_for(device, world_size)
    with tempfile.TemporaryDirectory(prefix="autourdf_launch_") as tmp:
        try:
            mp.start_processes(_rank_main, args=(fn, args, world_size, backend, device, tmp,
                                                 timeout_s),
                               nprocs=world_size, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            causes = "".join(f"\n-- {os.path.basename(p)[:-4]}:\n{open(p).read()}"
                             for p in sorted(glob.glob(os.path.join(tmp, "rank*.err"))))
            raise RuntimeError(f"{fn.__name__} failed on {world_size} ranks:{causes}") from e
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
