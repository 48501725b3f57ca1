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

``init_distributed`` (``jax.distributed.initialize``, several processes)
is not ported: ROADMAP A10.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["DeviceMesh", "auto_mesh", "shard_leading", "replicate", "init_distributed"]


class DeviceMesh:
    """Devices laid out on named axes, read like a ``jax.sharding.Mesh``:
    ``mesh.shape[mesh.axis_names[0]]`` is the size of the first axis.

    :param devices: ``torch.device``\\ s (or strings), in mesh order; a
        device may repeat.
    :param axis_names: one name per mesh axis.
    :param shape: the mesh's shape; default every device on the first axis.
    """

    def __init__(self, devices, axis_names=("outputs",), shape=None):
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

    def shard_devices(self, axis_name=None):
        """The device of each shard along ``axis_name`` (default the first
        axis): the first device of each slice of the mesh along it."""
        axis = self.axis_names.index(axis_name or self.axis_names[0])
        grid = np.empty(len(self.devices), dtype=object)
        grid[:] = self.devices
        grid = np.moveaxis(grid.reshape(tuple(self.shape.values())), axis, 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    @property
    def threaded(self):
        """Whether shards run on threads: the mesh holds distinct CUDA
        devices."""
        return (len(self.devices) > 1 and all(d.type == "cuda" for d in self.devices)
                and len(set(self.devices)) == len(self.devices))

    def __repr__(self):
        return "DeviceMesh({}, axis_names={}, shape={})".format(
            [str(d) for d in self.devices], self.axis_names, self.shape)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Not ported: the multi-process runtime (``jax.distributed.initialize``
    in ``mogp_tpu``) is ROADMAP A10."""
    raise NotImplementedError(
        "init_distributed (multi-process runs) is not ported to mogp_tpu_torch: ROADMAP A10"
    )


def auto_mesh(n_devices=None, axis_names=("outputs",), shape=None, device=None):
    """A :class:`DeviceMesh` over the available devices.

    With CUDA (``device`` ``None`` or ``"cuda"``) it takes ``cuda:0`` ...
    ``cuda:n-1``, all of them by default, and raises if ``n_devices`` is
    more than ``torch.cuda.device_count()``; it never repeats a card.  With
    ``device="cpu"`` it takes ``n_devices`` (default 1) entries of the CPU,
    whose shards then run one after another.

    :param axis_names: logical axis names; default one ``outputs`` axis.
    :param shape: explicit mesh shape; default all devices on the first axis.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n_devices = count if n_devices is None else int(n_devices)
        if not 1 <= n_devices <= count:
            raise ValueError("auto_mesh: {} CUDA devices asked for, {} available".format(
                n_devices, count))
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        n_devices = 1 if n_devices is None else int(n_devices)
        if n_devices < 1:
            raise ValueError("auto_mesh needs at least one device")
        devices = [device] * n_devices
    return DeviceMesh(devices, axis_names, shape)


def check_mesh(mesh):
    """``mesh`` itself if it is ``None`` or a :class:`DeviceMesh`; else
    ``TypeError``."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a mogp_tpu_torch.parallel.DeviceMesh or None, got {}"
                        .format(type(mesh).__name__))
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
    """
    devices = mesh.shard_devices()
    if n_items is not None:
        devices = devices[:n_items]
    grad = torch.is_grad_enabled()
    if mesh.threaded and len(devices) > 1:
        with ThreadPoolExecutor(max_workers=len(devices)) as pool:
            futures = [pool.submit(_on_device, d, grad, fn, k, d) for k, d in enumerate(devices)]
            return [f.result() for f in futures]
    return [_on_device(d, grad, fn, k, d) for k, d in enumerate(devices)]


def split_rows(n, n_shards):
    """``[slice]`` of ``n`` rows over ``n_shards`` shards, consecutive and
    as equal as they can be (the first ``n % n_shards`` one row longer);
    empty shards are left out."""
    bounds = np.cumsum([0] + [n // n_shards + (k < n % n_shards) for k in range(n_shards)])
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
