"""The multi-device layer: a device mesh and the sharded fit and prediction.

Port of ``mogp_tpu/parallel``.  A :class:`DeviceMesh` names the devices;
the ``mesh=`` argument of ``fit_GP_MAP``, ``HistoryMatching``,
``sample_GP_MCMC``, ``sample_MOGP_MCMC``, ``smc_history_match`` and
``DeviceMICEDesign`` splits their batch axis over it (``mesh.py``).
``init_distributed`` (several processes) raises: ROADMAP A10.
"""

from .mesh import DeviceMesh, auto_mesh, init_distributed, replicate, shard_leading
from .sharded import sharded_fit_mogp, sharded_predict, sharded_predict_mogp

__all__ = [
    "DeviceMesh",
    "auto_mesh",
    "init_distributed",
    "replicate",
    "shard_leading",
    "sharded_fit_mogp",
    "sharded_predict",
    "sharded_predict_mogp",
]
