"""Worlds of local processes for the port's mesh tests and fuzzer.

A world is ``world`` processes started with the ``spawn`` method, joined
into one ``torch.distributed`` process group by a ``file://`` rendezvous;
each runs ``fn(rank, world, *args)`` and sends its result back.  This
module imports only the standard library, numpy, torch and the port: a
spawned child imports the module that defines its function, and it must
not import JAX.

    out = spawn_world(run_calls, 4, ("cpu", calls), rendezvous_dir=tmp)

``run_calls`` runs a list of calls of ``exblas_tpu_torch.parallel`` (each
a dict: ``key``, ``entry``, ``args``, ``kwargs``, ``mesh``) on one mesh of
the world and returns each call's bits as numpy, keyed.
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import os
import pickle
import queue
import sys
import threading
import time
import traceback
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

WORLD_TIMEOUT = 120.0  # seconds a world may take, start-up included
MAX_RANKS = 12         # processes of the worlds run side by side, at most


def _child(fn, rank, world, backend, init_file, device_type, inbox, out):
    try:
        args = inbox.get(timeout=WORLD_TIMEOUT)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def spawn_world(fn, world: int, args=(), backend: str = "gloo",
                device_type: str = "cpu", rendezvous_dir=None,
                timeout: float = WORLD_TIMEOUT) -> list:
    """``fn(rank, world, *args)`` in each rank of a new world -> the results
    by rank.  Raises if a rank fails, and kills every child that is still
    alive after ``timeout`` seconds.  ``args`` goes to the children by a
    queue once they have started (their imports run side by side); CPU
    tensors in it reach them through shared memory."""
    ctx = tmp.get_context("spawn")
    inbox, out = ctx.Queue(), ctx.Queue()
    init_file = os.path.join(rendezvous_dir or os.getcwd(),
                             f"rendezvous-{world}-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, world, backend, init_file,
                               device_type, inbox, out))
             for rank in range(world)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put(args)
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world}: ranks "
                                   f"{sorted(set(range(world)) - set(results))}"
                                   f" gave no result in {timeout} s")
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"world of {world}: ranks {dead} died "
                                       f"(exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"world of {world}, rank {rank}:\n"
                                   f"{payload}")
            results[rank] = payload
    finally:
        inbox.cancel_join_thread()  # a dead child leaves its args unread
        for p in procs:
            p.join(timeout=max(1.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        with contextlib.suppress(FileNotFoundError):
            os.remove(init_file)
    return [results[r] for r in range(world)]


def spawn_worlds(fn, jobs: dict, max_ranks: int = MAX_RANKS, **kw) -> dict:
    """:func:`spawn_world` for each ``world: args`` item of ``jobs`` ->
    ``{world: results by rank}``.  Worlds run side by side in waves of at
    most ``max_ranks`` processes (the largest first); a failed world
    raises once its wave has ended."""
    waves, wave = [], []
    for world in sorted(jobs, reverse=True):
        if wave and sum(wave) + world > max_ranks:
            waves.append(wave)
            wave = []
        wave.append(world)
    waves.append(wave)
    results, errors = {}, []

    def run(world):
        try:
            results[world] = spawn_world(fn, world, jobs[world], **kw)
        except Exception as e:  # raised below, after the wave
            errors.append(e)

    for wave in waves:
        threads = [threading.Thread(target=run, args=(w,)) for w in wave]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * kw.get("timeout", WORLD_TIMEOUT))
        if errors or any(t.is_alive() for t in threads):
            raise errors[0] if errors else TimeoutError(
                f"worlds {wave} did not end")
    return results


# --- the calls a world runs ------------------------------------------------

def build_mesh(spec, world: int, device_type: str):
    """A mesh of the world from its spec: ``("1d",)`` or
    ``("2d", (p, q), axes)``."""
    from exblas_tpu_torch import parallel as xp

    if spec[0] == "1d":
        return xp.make_mesh(world, device_type=device_type)
    return xp.make_mesh_2d(spec[1], axes=spec[2], device_type=device_type)


def psum_state(kind: str, parts, mesh):
    """This rank's part (``parts[rank]``: a vector, or a pair for a dot)
    accumulated exactly, the accumulators merged by ``psum_superacc``:
    the total's (canonical digits, negative, special counts) as numpy."""
    import exblas_tpu_torch as xt
    from exblas_tpu_torch.core.rounding import canonicalize_digits
    from exblas_tpu_torch.parallel import psum_superacc
    from exblas_tpu_torch.parallel.distributed import mesh_device

    dev = mesh_device(mesh)
    part = parts[mesh.get_local_rank()]
    acc = (xt.exsum_acc(part, device=dev) if kind == "sum"
           else xt.exdot_acc(*part, device=dev))
    total = psum_superacc(acc, mesh)
    digits, negative = canonicalize_digits(total.limbs)
    return (digits.cpu().numpy(), bool(negative),
            total.special.cpu().numpy().astype(np.int64))


def mesh_ranks(mesh):
    """(ranks in the mesh, this rank's index in it, whether this process
    has imported JAX)."""
    return mesh.size(), mesh.get_local_rank(), "jax" in sys.modules


def make_mesh_error(n_devices: int, mesh):
    """The error ``make_mesh(n_devices)`` raises in this world, as text."""
    from exblas_tpu_torch import parallel as xp

    try:
        xp.make_mesh(n_devices, device_type=mesh.device_type)
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def entry_error(name: str, *args, mesh, **kwargs):
    """The ValueError the entry ``name`` raises on these arguments, as
    text."""
    try:
        entry(name)(*args, mesh=mesh, **kwargs)
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def entry(name: str):
    """A callable taking ``(*args, mesh=..., **kwargs)``: an entry of
    ``exblas_tpu_torch.parallel`` or one of this module's probes."""
    from exblas_tpu_torch import parallel as xp

    probes = {"psum_state": psum_state, "mesh_ranks": mesh_ranks,
              "make_mesh_error": make_mesh_error, "entry_error": entry_error}
    return probes.get(name) or getattr(xp, name)


def as_numpy(result):
    if isinstance(result, torch.Tensor):
        return result.cpu().numpy()
    return result


def run_calls(rank: int, world: int, device_type: str, calls) -> dict:
    """Every call in this rank, each on the world's mesh of its spec (each
    mesh built once) -> ``{key: result}``, bits as numpy."""
    meshes, out = {}, {}
    for call in calls:
        spec = call.get("mesh", ("1d",))
        if spec not in meshes:
            meshes[spec] = build_mesh(spec, world, device_type)
        out[call["key"]] = as_numpy(entry(call["entry"])(
            *call["args"], mesh=meshes[spec], **call.get("kwargs", {})))
    return out


# --- one computation shared by the test workers of one run -----------------

def shared_result(tmp_path_factory, name: str, compute):
    """``compute(directory)`` once per test run, its result shared by every
    pytest-xdist worker of the run through a pickle under a lock (the
    first worker computes; the others wait and read).  Under the suite's
    own ``--dist load`` scheduler (the root ``conftest.py``) a module that
    uses it is one unit, so one worker computes and reads; the lock serves
    runs without that scheduler.  Without xdist it is computed in the
    process."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return compute(tmp_path_factory.mktemp(name))
    root = tmp_path_factory.getbasetemp().parent / f"{name}-{run}"
    root.mkdir(exist_ok=True)
    result = root / "result.pickle"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if result.exists():
                return pickle.loads(result.read_bytes())
            value = compute(root)
            part = root / "result.part"
            part.write_bytes(pickle.dumps(value))
            part.replace(result)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
