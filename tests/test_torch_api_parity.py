"""API parity: every public name of ``mogp_tpu`` exists in the port.

For ``mogp_tpu`` and every subpackage and module of it (``models``, ``ops``,
``ops.hmc``, ``uq``, ``utils``, ``parallel``, ...), each name of its
``__all__`` must exist in the port's module of the same path.  Outside the
API is the TPU platform layer, which ROADMAP lists as not the port's work:
``config``'s TPU switches, ``native`` (a host oracle) and ``ops.blocked``
(TPU tiling), and ``ops.pallas_kernels``, whose kernel the port has as
``ops.kernel_matrix``.  The one listed exception inside the API is
``parallel.init_distributed``: it exists and raises, naming ROADMAP A10.
"""

import importlib
import pkgutil

import pytest

torch = pytest.importorskip("torch")

import mogp_tpu  # noqa: E402
import mogp_tpu_torch  # noqa: E402

PLATFORM = {"mogp_tpu.config", "mogp_tpu.native", "mogp_tpu.ops.blocked",
            "mogp_tpu.ops.pallas_kernels"}
EXCEPTIONS = {("mogp_tpu.parallel", "init_distributed"),
              ("mogp_tpu.parallel.mesh", "init_distributed")}

MODULES = ["mogp_tpu"] + sorted(m.name for m in pkgutil.walk_packages(mogp_tpu.__path__,
                                                                       "mogp_tpu."))


def _port_name(name):
    return "mogp_tpu_torch" + name[len("mogp_tpu"):]


def test_every_module_is_ported_or_platform():
    """The walk sees the whole package: every module outside the platform
    layer has a counterpart file in the port."""
    assert {"mogp_tpu.ops.hmc", "mogp_tpu.parallel.sharded", "mogp_tpu.uq.dimension_reduction",
            "mogp_tpu.utils.misc"} <= set(MODULES)
    assert PLATFORM <= set(MODULES)
    for name in MODULES:
        if name not in PLATFORM:
            assert importlib.util.find_spec(_port_name(name)) is not None, name


@pytest.mark.parametrize("name", [m for m in MODULES if m not in PLATFORM])
def test_public_names_exist_in_the_port(name):
    mod = importlib.import_module(name)
    port = importlib.import_module(_port_name(name))
    missing = [a for a in getattr(mod, "__all__", [])
               if not hasattr(port, a) and (name, a) not in EXCEPTIONS]
    assert missing == [], "{} lacks {}".format(port.__name__, missing)


def test_the_listed_exception_raises_and_names_a10():
    from mogp_tpu_torch.parallel import init_distributed

    for name, attr in EXCEPTIONS:
        assert getattr(importlib.import_module(_port_name(name)), attr) is init_distributed
    with pytest.raises(NotImplementedError, match="A10"):
        init_distributed()


def test_the_closed_gaps():
    """The names the parity check found missing before this slice."""
    from mogp_tpu_torch.ops import hmc
    from mogp_tpu_torch.utils import misc

    assert mogp_tpu_torch.utils.k_fold_cross_validation is misc.k_fold_cross_validation
    assert mogp_tpu_torch.utils.integer_bisect is misc.integer_bisect
    assert callable(hmc.nuts_kernel)
    assert callable(mogp_tpu_torch.Kernel.SquaredExponential().kernel_hessian)


def test_nuts_kernel_step_equals_nuts_step():
    """One step of the factory's kernel is ``nuts_step`` on the stream's
    draws of that transition, bit for bit."""
    from mogp_tpu_torch.ops import hmc

    def potential(q):
        return 0.5 * torch.sum(q * q * torch.tensor([1.0, 4.0], dtype=q.dtype), dim=-1)

    L = 5
    q = torch.linspace(-1.0, 1.0, 2 * L, dtype=torch.float64).reshape(L, 2)
    u, g = hmc.potential_and_grad(potential)(q)
    step_size = torch.full((L,), 0.4, dtype=torch.float64)
    inv_mass = torch.ones((L, 2), dtype=torch.float64)
    stream = hmc.Stream(3, torch.arange(L), torch.zeros(L, dtype=torch.int64))
    got = hmc.nuts_kernel(potential, max_depth=6)(stream, 7, q, u, g, step_size, inv_mass)
    draws = hmc._transition_draws(stream, 7, 2, 6)
    ref = hmc.nuts_step(hmc.potential_and_grad(potential), q, u, g, step_size, inv_mass, draws,
                        max_depth=6)
    for a, b in zip(got[:3], ref[:3]):
        assert torch.equal(a, b)
    for a, b in zip(got[3], ref[3]):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], q)
