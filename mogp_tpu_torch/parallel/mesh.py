"""The device mesh of the port, and how work is split over it.

Port of ``mogp_tpu/parallel/mesh.py``.  JAX places one program on a
``jax.sharding.Mesh`` and GSPMD partitions it; PyTorch has no such
partitioner, so a :class:`DeviceMesh` is a list of ``torch.device``\\ s
with the shape and axis names of a JAX mesh, and the sharded entry points
split their batch axis over it themselves:

* :func:`shard_leading` cuts a tree of tensors along its leading axis into
  one piece per shard of the mesh's first axis, and :func:`replicate`
  copies one onto every device;
* :func:`map_shards` runs one function per shard and returns the results
  in shard order.  On distinct CUDA devices each shard runs on a host
  thread of its own under ``torch.cuda.device(d)``, so the cards work at
  once; on a mesh that repeats a device (the CPU, or one card named four
  times) the shards run one after another, which drives the same split and
  merge.

Everything random is drawn before the split (on the host, or on the
mesh's first device), and every shard keeps the global indices of its
lanes, so a result does not depend on the mesh.

Several processes (``jax.distributed.initialize`` in ``mogp_tpu``): every
process calls :func:`init_distributed`, which joins them in one
``torch.distributed`` group; :func:`auto_mesh` then spans every process's
devices in process order, and the :class:`DeviceMesh` records which
process owns each entry.  :func:`map_shards` runs this process's shards
only, and hands every shard's result to every process.  Only the MAP fit
(``fit_GP_MAP``, ``sharded_fit_mogp``) and ``sample_MOGP_MCMC`` take such
a mesh, as only theirs run across processes in ``mogp_tpu``; every other
``mesh=`` path raises ``RuntimeError`` (:func:`check_mesh`).
"""

import datetime
import io
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["DeviceMesh", "auto_mesh", "shard_leading", "replicate", "init_distributed"]

# every collective of the process group fails after this long, so a
# process whose peer died raises instead of waiting for ever
_TIMEOUT = datetime.timedelta(seconds=300)


class _World(NamedTuple):
    """The process group of :func:`init_distributed`: this process's index
    and every process's device, in process order."""

    index: int
    devices: List[str]


_world = None

# (seconds, bytes this process sent) of every gather of map_shards across
# processes; the MAP fit clears it when it starts
last_gathers = []


def process_count():
    """The number of processes joined by :func:`init_distributed` (1
    before it), as ``jax.process_count()``."""
    return 1 if _world is None else len(_world.devices)


def process_index():
    """This process's index among them (0 before :func:`init_distributed`),
    as ``jax.process_index()``."""
    return 0 if _world is None else _world.index


class DeviceMesh:
    """Devices laid out on named axes, read like a ``jax.sharding.Mesh``:
    ``mesh.shape[mesh.axis_names[0]]`` is the size of the first axis.

    :param devices: ``torch.device``\\ s (or strings), in mesh order; a
        device may repeat.
    :param axis_names: one name per mesh axis.
    :param shape: the mesh's shape; default every device on the first axis.
    :param processes: the index of the process that owns each device
        (:func:`init_distributed`), in mesh order; default this process
        owns them all.
    """

    def __init__(self, devices, axis_names=("outputs",), shape=None, processes=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")
        self.axis_names = tuple(axis_names)
        if shape is None:
            shape = (len(self.devices),) + (1,) * (len(self.axis_names) - 1)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.axis_names) or int(np.prod(shape)) != len(self.devices):
            raise ValueError("mesh shape {} does not hold {} devices on axes {}".format(
                shape, len(self.devices), self.axis_names))
        self.shape = dict(zip(self.axis_names, shape))
        if processes is not None:
            processes = [int(p) for p in processes]
            if (len(processes) != len(self.devices)
                    or not all(0 <= p < process_count() for p in processes)):
                raise ValueError("mesh processes {} do not name one of the {} joined processes "
                                 "for each of {} devices".format(processes, process_count(),
                                                                 len(self.devices)))
        self.processes = processes

    def _first_along(self, values, axis_name):
        """The first of ``values`` (one per device) in each slice of the
        mesh along ``axis_name`` (default the first axis)."""
        axis = self.axis_names.index(axis_name or self.axis_names[0])
        grid = np.empty(len(values), dtype=object)
        grid[:] = values
        grid = np.moveaxis(grid.reshape(tuple(self.shape.values())), axis, 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def shard_devices(self, axis_name=None):
        """The device of each shard along ``axis_name`` (default the first
        axis): the first device of each slice of the mesh along it."""
        return self._first_along(self.devices, axis_name)

    def _owners(self):
        return self.processes or [process_index()] * len(self.devices)

    def shard_processes(self, axis_name=None):
        """The process that runs each shard along ``axis_name``: the owner
        of the shard's device."""
        return self._first_along(self._owners(), axis_name)

    @property
    def spans_processes(self):
        """Whether the mesh's entries belong to several joined processes:
        its shards' results then cross between them."""
        return self.processes is not None and process_count() > 1

    @property
    def threaded(self):
        """Whether this process's shards run on threads: the entries it
        owns are distinct CUDA devices."""
        mine = [d for d, p in zip(self.devices, self._owners()) if p == process_index()]
        return (len(mine) > 1 and all(d.type == "cuda" for d in mine)
                and len(set(mine)) == len(mine))

    def __repr__(self):
        procs = "" if self.processes is None else ", processes={}".format(self.processes)
        return "DeviceMesh({}, axis_names={}, shape={}{})".format(
            [str(d) for d in self.devices], self.axis_names, self.shape, procs)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Join this process to ``num_processes`` processes, as
    ``jax.distributed.initialize`` does in ``mogp_tpu``.

    Call it once in every process, before building a mesh; the group is
    ``torch.distributed``'s, on the gloo backend (the results that cross
    are host arrays, and gloo lets two processes share one card, which
    NCCL refuses).  Every collective fails after five minutes.

    :param coordinator_address: ``"host:port"`` where process 0 listens.
    :param num_processes: the number of processes.
    :param process_id: this process's index, ``0 ... num_processes - 1``.

    An argument left ``None`` is read from torchrun's environment
    (``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); where
    neither gives it, ``ValueError`` names what is missing.

    Each process's device: where CUDA is available, ``cuda:LOCAL_RANK``
    under torchrun, else ``cuda:(process_id % device_count)``; it becomes
    the current device, so the default ``device="cuda"`` means it.  The
    devices are exchanged once here.  :func:`auto_mesh` then gives one
    entry per process (its card; two processes may share one), and
    ``auto_mesh(n, device="cpu")`` gives ``n / num_processes`` CPU entries
    to each process in turn, the counterpart of XLA's
    ``--xla_force_host_platform_device_count``: ``auto_mesh(8,
    device="cpu")`` on two processes is four entries each.

    Every process runs the same program on the same inputs, its random
    draws included: ``fit_GP_MAP`` draws its restarts from numpy's global
    RNG in each process, so every process seeds it alike
    (``np.random.seed``) before the fit, as ``mogp_tpu``'s processes do.
    """
    global _world
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = "{}:{}".format(env["MASTER_ADDR"], env["MASTER_PORT"])
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [name for name, value in (("coordinator_address", coordinator_address),
                                        ("num_processes", num_processes),
                                        ("process_id", process_id)) if value is None]
    if missing:
        raise ValueError("init_distributed: {} not given, and not in torchrun's environment "
                         "(MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK)".format(
                             ", ".join(missing)))
    num_processes, process_id = int(num_processes), int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError("init_distributed: process_id {} is not in 0 ... {}".format(
            process_id, num_processes - 1))
    host, sep, port = str(coordinator_address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError("init_distributed: coordinator_address {!r} is not 'host:port'".format(
            coordinator_address))
    dist.init_process_group("gloo", init_method="tcp://{}:{}".format(host, port),
                            world_size=num_processes, rank=process_id, timeout=_TIMEOUT)
    if torch.cuda.is_available():
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    devices = [None] * num_processes
    dist.all_gather_object(devices, str(device))
    _world = _World(process_id, devices)


def auto_mesh(n_devices=None, axis_names=("outputs",), shape=None, device=None):
    """A :class:`DeviceMesh` over the available devices.

    With CUDA (``device`` ``None`` or ``"cuda"``) it takes ``cuda:0`` ...
    ``cuda:n-1``, all of them by default, and raises if ``n_devices`` is
    more than ``torch.cuda.device_count()``; it never repeats a card.  With
    ``device="cpu"`` it takes ``n_devices`` (default 1) entries of the CPU,
    whose shards then run one after another.

    After :func:`init_distributed` it spans the processes, in process
    order: with CUDA the first ``n_devices`` (default all) of their devices,
    one per process; with ``device="cpu"`` ``n_devices`` (default one per
    process, else a multiple of the process count) entries, an equal run
    of them per process.

    :param axis_names: logical axis names; default one ``outputs`` axis.
    :param shape: explicit mesh shape; default all devices on the first axis.
    """
    device = resolve_device(device)
    processes = None
    if device.type == "cuda":
        if _world is None:
            available = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            available = [torch.device(d) for d in _world.devices]
        n_devices = len(available) if n_devices is None else int(n_devices)
        if not 1 <= n_devices <= len(available):
            raise ValueError("auto_mesh: {} CUDA devices asked for, {} available".format(
                n_devices, len(available)))
        devices = available[:n_devices]
        if _world is not None:
            processes = list(range(n_devices))
    else:
        n_proc = process_count()
        n_devices = n_proc if n_devices is None else int(n_devices)
        if n_devices < 1 or n_devices % n_proc:
            raise ValueError("auto_mesh: {} CPU entries cannot be shared by {} processes".format(
                n_devices, n_proc))
        devices = [device] * n_devices
        if _world is not None:
            processes = [k // (n_devices // n_proc) for k in range(n_devices)]
    return DeviceMesh(devices, axis_names, shape, processes)


def check_mesh(mesh, across_processes=False):
    """``mesh`` itself if it is ``None`` or a :class:`DeviceMesh`; else
    ``TypeError``.  A mesh that spans processes raises ``RuntimeError``
    unless the caller gathers across them (``across_processes``: the MAP
    fit and ``sample_MOGP_MCMC``), as the other paths fail on such a mesh
    in ``mogp_tpu``."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a mogp_tpu_torch.parallel.DeviceMesh or None, got {}"
                        .format(type(mesh).__name__))
    if mesh is not None and mesh.spans_processes and not across_processes:
        raise RuntimeError(
            "{} spans {} processes: only the MAP fit (fit_GP_MAP, sharded_fit_mogp) and "
            "sample_MOGP_MCMC gather their results across processes, as in mogp_tpu; give "
            "this path a mesh of this process's own devices".format(mesh, process_count()))
    return mesh


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of NamedTuples, tuples, lists and
    dicts; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def to_device(tree, device):
    """The tensors of ``tree`` on ``device`` (no copy where they are)."""
    return _tree_map(lambda x: x.to(device), tree)


def shard_leading(tree, mesh, axis_name=None):
    """One piece of ``tree`` per shard along ``axis_name`` (default the
    first axis), on the shard's device: tensors whose leading axis the
    shard count divides are cut into equal consecutive parts, the others
    (scalars, packed priors) are replicated (``mesh.py:54-71``)."""
    devices = mesh.shard_devices(axis_name)
    n = len(devices)

    def piece(k):
        def cut(x):
            if x.ndim >= 1 and x.shape[0] % n == 0:
                step = x.shape[0] // n
                x = x[k * step:(k + 1) * step]
            return x.to(devices[k])
        return _tree_map(cut, tree)

    return [piece(k) for k in range(n)]


def replicate(tree, mesh):
    """``tree`` on every device of the mesh, in mesh order."""
    return [to_device(tree, d) for d in mesh.devices]


def _on_device(device, grad_enabled, fn, *args):
    with torch.set_grad_enabled(grad_enabled):
        if device.type == "cuda":
            with torch.cuda.device(device):
                return fn(*args)
        return fn(*args)


def map_shards(mesh, fn, n_items=None):
    """``[fn(k, device_k) for each shard k]`` of the mesh's first axis, in
    shard order.

    On distinct CUDA devices (:attr:`DeviceMesh.threaded`) each call runs on
    a thread of its own under ``torch.cuda.device(device_k)``, with the
    caller's grad mode; otherwise one after another.  ``n_items`` limits
    the calls to the first ``n_items`` shards (fewer items than shards).
    Every call's exception is raised in the caller.

    On a mesh that spans processes (:attr:`DeviceMesh.spans_processes`)
    this process calls ``fn`` for its own shards only, then every process
    receives every shard's result, its tensors on the CPU: one gather
    (:func:`_all_gather_bytes`), which every process makes whatever its
    share, so the processes' collectives stay in step.  A shard that raised
    is raised in every process (this one its own exception, the others a
    ``RuntimeError`` that names it).
    """
    devices = mesh.shard_devices()
    if n_items is not None:
        devices = devices[:n_items]
    owners = mesh.shard_processes()[:len(devices)]
    mine = [k for k, p in enumerate(owners) if p == process_index()]
    grad = torch.is_grad_enabled()

    def run():
        if mesh.threaded and len(mine) > 1:
            with ThreadPoolExecutor(max_workers=len(mine)) as pool:
                futures = [pool.submit(_on_device, devices[k], grad, fn, k, devices[k])
                           for k in mine]
                return [f.result() for f in futures]
        return [_on_device(devices[k], grad, fn, k, devices[k]) for k in mine]

    if not mesh.spans_processes:
        return run()
    try:
        local = {"results": dict(zip(mine, _tree_map(lambda x: x.cpu(), run())))}
        error = None
    except Exception as exc:  # every process must reach the gather below
        local, error = {"error": "process {}: {}: {}".format(
            process_index(), type(exc).__name__, exc)}, exc
    t0 = time.perf_counter()
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(local)
    payload = buf.getvalue()
    parts = [pickle.loads(b) for b in _all_gather_bytes(payload)]
    last_gathers.append((time.perf_counter() - t0, len(payload)))
    if error is not None:
        raise error
    failed = [p["error"] for p in parts if "error" in p]
    if failed:
        raise RuntimeError("a shard failed in another process: " + "; ".join(failed))
    results = {}
    for p in parts:
        results.update(p["results"])
    return [results[k] for k in range(len(devices))]


class _Pickler(pickle.Pickler):
    """Pickles a CPU tensor as its numpy array, which is several times
    quicker to pickle and load than a tensor, and as exact."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return torch.from_numpy, (obj.detach().numpy(),)
        return NotImplemented


def _all_gather_bytes(payload):
    """Every joined process's ``payload`` (bytes), in process order: the
    lengths first, then the payloads padded to the longest (gloo's
    ``all_gather`` wants equal shapes) and cut back."""
    import torch.distributed as dist

    n = process_count()
    size = torch.tensor([len(payload)], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    longest = max(int(s) for s in sizes)
    mine = torch.zeros(longest, dtype=torch.uint8)
    mine[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    out = [torch.empty(longest, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(out, mine)
    return [o[:int(s)].numpy().tobytes() for o, s in zip(out, sizes)]


def split_rows(n, n_shards):
    """``[slice]`` of ``n`` rows over ``n_shards`` shards, consecutive and
    as equal as they can be (the first ``n % n_shards`` one row longer);
    empty shards are left out."""
    bounds = np.cumsum([0] + [n // n_shards + (k < n % n_shards) for k in range(n_shards)])
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
