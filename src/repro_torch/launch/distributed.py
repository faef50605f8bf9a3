"""LM training on a mesh of ``torch.distributed`` ranks.

The reference's ``examples/distributed_smoke.py`` jits one train step over
a (data x model) device mesh; here each mesh position is a process.
:func:`run_ranks` starts the world (``torch.multiprocessing`` spawn,
rendezvous on a ``FileStore``) and returns each rank's result;
:func:`train_on_mesh` is one rank's part of a list of :class:`MeshJob`:
build its :class:`~repro_torch.common.sharding.RankMesh`, place its shards
of the parameters and AdamW state, train on its batch rows with
``make_train_step(..., mesh=...)``, and checkpoint the gathered state.

The backend is chosen once, from the card count (:func:`choose_backend`):
``nccl`` when each rank has a card of its own, gloo on CPU ranks under
``device="cpu"``, and gloo on a shared card otherwise (NCCL refuses two
ranks on one device), its collectives staged through host memory
(``common/collectives.py``).  Nothing switches backend on an error, no
rank moves to the CPU, and a rank that raises fails the run: the others
are stopped and :func:`run_ranks` raises with that rank's traceback.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.sharding import P, RankMesh, gather_tree, shard_tree
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import get_lm_config
from repro_torch.data.pipeline import DataConfig, token_batch
from repro_torch.launch.steps import get_adapter, make_train_step, opt_pspecs
from repro_torch.optim import AdamWConfig, init_adamw

#: the batch's layout, ``P(("data",), None)``: each data shard its rows
BATCH_SPECS = {"inputs": P("data"), "labels": P("data")}


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str  # "nccl" | "gloo"
    devices: tuple[str, ...]  # each rank's device
    describe: str  # one line for the run's log


def choose_backend(device: str, world: int) -> Backend:
    """The backend for ``world`` ranks on ``device`` ("cuda" | "cpu"), from
    the visible card count.  Raises on "cuda" with no card visible."""
    if device == "cpu":
        return Backend("gloo", ("cpu",) * world, f"gloo, {world} CPU ranks")
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass --device cpu to run the ranks "
                           "on the CPU")
    if n >= world:
        return Backend("nccl", tuple(f"cuda:{r}" for r in range(world)),
                       f"nccl, one card a rank ({world} of {n} cards)")
    return Backend("gloo", tuple(f"cuda:{r % n}" for r in range(world)),
                   f"gloo, {world} ranks sharing {n} card(s), collectives staged through "
                   "host memory")


def _rank_main(rank: int, world: int, store: str, backend: str, device: str, timeout_s: float,
               fn: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # a rank a core: eight ranks on eight cores
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(dev, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def _failures(results, failed: dict[int, str], world: int, grace_s: float = 2.0) -> str:
    """Every failed rank's traceback that arrives within ``grace_s`` of the
    first: a rank's error often makes its peers fail too, and the first to
    report need not be the cause."""
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            rank, ok, value = results.get(timeout=max(0.01, end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"rank {r} of {world} failed:\n{tb}" for r, tb in sorted(failed.items()))


def run_ranks(fn: Callable, args: tuple, backend: Backend, rendezvous: str,
              timeout_s: float = 600.0) -> list[Any]:
    """``fn(device, *args)`` on each of ``len(backend.devices)`` ranks after
    ``torch.distributed`` is initialised (rendezvous: a fresh ``FileStore``
    at the path ``rendezvous``); each rank's return value, in rank order.
    ``fn`` and ``args`` are pickled to the spawned ranks.  Raises
    ``RuntimeError`` when a rank fails or the run outlasts ``timeout_s``,
    after stopping every rank."""
    import torch.multiprocessing as mp

    world = len(backend.devices)
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    os.makedirs(os.path.dirname(os.path.abspath(rendezvous)), exist_ok=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, rendezvous, backend.name,
                                                  backend.devices[r], timeout_s, fn, args,
                                                  results))
             for r in range(world)]
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks did not finish in {timeout_s} s; "
                                       f"{len(out)} of {world} did") from None
                continue
            if not ok:
                raise RuntimeError(_failures(results, {rank: value}, world))
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:  # started
                p.join()
        results.close()
        if os.path.exists(rendezvous):
            os.remove(rendezvous)
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# One rank's training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshJob:
    """A training run on a (data x model) mesh of ranks.  Step ``s`` trains
    on ``token_batch(DataConfig(global_batch, seq_len), s)``, each data
    shard on its rows."""

    arch: str
    mesh: tuple[int, int]  # (data, model)
    steps: tuple[int, int]  # [first, last): the steps' numbers
    global_batch: int
    seq_len: int = 65  # tokens a row: inputs and labels are one shorter
    variant: str = "smoke"
    opt: AdamWConfig = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    remat: bool = False
    #: a CheckpointManager directory to start from (its newest step), else
    #: the adapter's init from seed 0 on the CPU's generator: the same
    #: weights whatever device the ranks run on
    restore: str | None = None
    #: a CheckpointManager directory: rank 0 saves the gathered
    #: ``{"params", "opt"}`` there after the last step, as step ``steps[1]``
    save: str | None = None
    #: return the gathered state (numpy) after every step from rank 0
    keep_states: bool = False


def _allocator(device: torch.device) -> tuple[int, int]:
    """(bytes the program asked the card's allocator for, bytes of the
    blocks it handed out): the second rounds each request up to its block."""
    stats = torch.cuda.memory_stats(device)
    return stats["requested_bytes.all.current"], stats["allocated_bytes.all.current"]


def _nbytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _numpy(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().float().cpu().numpy() if x.is_floating_point()
                    else x.detach().cpu().numpy(), tree)


def _place(job: MeshJob, adapter, tspecs, mesh: RankMesh) -> tuple[Any, Any]:
    """The rank's shards of the parameters and AdamW state (``tspecs``:
    their spec trees under ``"params"`` and ``"opt"``)."""
    dev = mesh.device
    if job.restore is None:
        full = adapter.init(torch.Generator().manual_seed(0), "cpu")
        params = shard_tree(full, tspecs["params"], mesh.mesh, mesh.coords)
        del full
        params = tree_map(lambda x: x.to(dev), params)
        return params, init_adamw(params)
    meta = adapter.init(torch.Generator().manual_seed(0), "meta")
    template = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype),
                        {"params": meta, "opt": init_adamw(meta)})
    restored = CheckpointManager(job.restore).restore_latest(template)
    if restored is None:
        raise FileNotFoundError(f"no committed checkpoint under {job.restore}")
    state = shard_tree(restored[1], tspecs, mesh.mesh, mesh.coords)
    state = tree_map(lambda x: x.to(dev), state)
    return state["params"], state["opt"]


def train_on_mesh(device: torch.device, jobs: list[MeshJob]) -> list[dict]:
    """This rank's part of each job, in order (every rank of the world runs
    the same list); per job: the loss and host wall seconds of each step
    (the card synchronised), the last step's collective bytes by ``(kind,
    tag, phase)``, bytes staged through the host and the staged calls'
    seconds, the rank's coordinates, its shards' bytes (parameters, AdamW
    state) and the seconds to place them and, on a card, the allocator's
    rise when they were placed (requested and block bytes) and the peak
    over the steps; the gathered state after each step from rank 0 when
    ``keep_states``."""
    meshes: dict[tuple[int, int], RankMesh] = {}
    out = []
    for job in jobs:
        if job.mesh not in meshes:
            meshes[job.mesh] = RankMesh.build(job.mesh, device=device)
        mesh = meshes[job.mesh]
        cfg = get_lm_config(job.arch, job.variant)
        adapter = get_adapter(cfg)
        specs = adapter.pspecs(job.mesh[1])
        tspecs = {"params": specs, "opt": opt_pspecs(specs)}
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            before = _allocator(device)
        t = time.perf_counter()
        params, opt = _place(job, adapter, tspecs, mesh)
        res: dict[str, Any] = dict(coords=mesh.coords, device=str(device),
                                   param_bytes=_nbytes(params), opt_bytes=_nbytes(opt),
                                   setup_s=time.perf_counter() - t)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            after = _allocator(device)
            res["requested_rise"] = after[0] - before[0]
            res["allocated_rise"] = after[1] - before[1]
            torch.cuda.reset_peak_memory_stats(device)
        step_fn = make_train_step(adapter, job.opt, remat=job.remat, mesh=mesh)
        dc = DataConfig(global_batch=job.global_batch, seq_len=job.seq_len,
                        vocab_size=cfg.vocab_size)
        losses, step_s, states = [], [], []
        for s in range(*job.steps):
            nb = token_batch(dc, s)
            batch = shard_tree({"inputs": torch.from_numpy(nb["tokens"]),
                                "labels": torch.from_numpy(nb["labels"])},
                               BATCH_SPECS, mesh.mesh, mesh.coords)
            batch = tree_map(lambda x: x.to(device), batch)
            mesh.reset_counts()
            t = time.perf_counter()
            params, opt, loss = step_fn(params, opt, batch)
            losses.append(float(loss))  # waits for the step's last kernel
            step_s.append(time.perf_counter() - t)
            counts, staged = dict(mesh.counts), dict(mesh.staged_bytes)
            staged_s = dict(mesh.seconds)
            if job.keep_states:
                full = gather_tree({"params": params, "opt": opt}, tspecs, mesh)
                if mesh.rank == 0:
                    states.append(_numpy(full))
                del full
        res.update(losses=losses, step_s=step_s, counts=counts, staged_bytes=staged,
                   staged_s=staged_s, states=states)
        if cuda:
            res["peak"] = torch.cuda.max_memory_allocated(device)
        if job.save is not None:
            full = gather_tree({"params": params, "opt": opt}, tspecs, mesh)
            if mesh.rank == 0:
                CheckpointManager(job.save, keep=2).save(job.steps[1], full)
            del full
        del params, opt
        out.append(res)
    return out


def n_params(arch: str, variant: str = "smoke") -> int:
    """The arch's parameter count (from ``meta`` tensors: no memory)."""
    meta = get_adapter(get_lm_config(arch, variant)).init(torch.Generator().manual_seed(0), "meta")
    return int(np.sum([x.numel() for x in tree_leaves(meta)]))
