"""Sequential (active-learning) experimental design, including MICE.

Port of ``mogp_tpu/uq/sequential_design.py``:

* ``SequentialDesign`` -- the state machine (initial design, next point /
  next target, batch points) and ``save_design`` / ``load_design`` in the
  same ``.npz`` format, so a design file written by one package loads in
  the other.
* ``MICEFastGP`` -- the leave-one-out variance of every candidate from one
  lower solve of the identity (:func:`_loo_variances_all`, the same
  function as ``mogp_tpu``'s Woodbury sum of ``L^-1 [C | I]``, without its
  cancellation).
* ``MICEDesign`` -- the MICE criterion ``unc_base / unc_cand`` over the
  candidates: a ``GaussianProcess`` MAP fit on standardized targets and a
  ``MICEFastGP`` on the candidates at its hyperparameters, in the JAX
  package's ten-try loop.

The GPs run on ``device`` (the card unless the caller passes
``device="cpu"``), in ``dtype`` (float32 on the card, float64 on the CPU
by default).  Every draw comes from numpy's global RNG in ``mogp_tpu``'s
order, so seeded runs of the two packages choose the same points.
"""

from inspect import signature

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..models.fitting import fit_GP_MAP
from ..models.gp import GaussianProcess
from ..ops._build import KernelError
from .experimental_design import ExperimentalDesign

__all__ = ["SequentialDesign", "MICEDesign", "MICEFastGP"]


class SequentialDesign:
    """Base sequential design (``mogp_tpu/uq/sequential_design.py:37-301``).

    ``device`` and ``dtype`` say where and in which type a subclass fits
    its GPs; the state machine itself runs on the host in numpy.
    """

    def __init__(self, base_design, f=None, n_samples=None, n_init=10, n_cand=50,
                 device=None, dtype=None):
        if not isinstance(base_design, ExperimentalDesign):
            raise TypeError("base design must be a one-shot experimental design")
        if f is not None:
            if not callable(f):
                raise TypeError("simulator f must be a function or other callable")
            if not len(signature(f).parameters) == 1:
                raise ValueError(
                    "simulator f must accept all parameters as a single input array"
                )
        if n_samples is not None and int(n_samples) < 0:
            raise ValueError("number of samples must be nonzero")
        if int(n_init) <= 0:
            raise ValueError("number of initial design points must be positive")
        if int(n_cand) <= 0:
            raise ValueError("number of candidate design points must be positive")

        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.base_design = base_design
        self.f = f
        self.n_samples = None if n_samples is None else int(n_samples)
        self.n_init = int(n_init)
        self.n_cand = int(n_cand)

        self.current_iteration = 0
        self.initialized = False
        self.inputs = None
        self.targets = None
        self.candidates = None

    # -- persistence --------------------------------------------------------

    def save_design(self, filename):
        np.savez(
            filename,
            inputs=self.inputs,
            targets=self.targets,
            candidates=self.candidates,
        )

    def load_design(self, filename):
        design_file = np.load(filename, allow_pickle=True)

        def unwrap(name):
            arr = np.array(design_file[name])
            if arr.shape == () and arr.dtype == object:
                return None
            return arr

        self.inputs = unwrap("inputs")
        self.targets = unwrap("targets")
        self.candidates = unwrap("candidates")

        if self.inputs is None:
            assert self.targets is None, (
                "Cannot have targets without corresponding inputs"
            )
        else:
            if self.targets is not None:
                assert self.targets.ndim == 1, "bad number of dimensions for targets"
                assert self.targets.shape[0] <= self.inputs.shape[0], (
                    "targets cannot be longer than inputs"
                )
                self.initialized = True
                self.current_iteration = self.targets.shape[0]
            assert self.get_n_parameters() == self.inputs.shape[1], (
                "Bad shape for inputs"
            )
            if self.inputs.shape[1] < self.n_init:
                print("n_init greater than number of inputs, changing n_init")
                self.n_init = self.inputs.shape[1]

        if self.candidates is not None:
            assert self.get_n_parameters() == self.candidates.shape[1], (
                "Bad shape for candidates"
            )
            if self.candidates.shape[0] != self.n_cand:
                print("shape of candidates differs from n_cand, candidates will "
                      "be overridden")

    # -- bookkeeping --------------------------------------------------------

    def has_function(self):
        return self.f is not None

    def get_n_parameters(self):
        return self.base_design.get_n_parameters()

    def get_n_init(self):
        return self.n_init

    def get_n_samples(self):
        return self.n_samples

    def get_n_cand(self):
        return self.n_cand

    def get_current_iteration(self):
        return self.current_iteration

    def get_inputs(self):
        return self.inputs

    def get_targets(self):
        return self.targets

    def get_candidates(self):
        return self.candidates

    def get_base_design(self):
        return type(self.base_design).__name__

    # -- design flow --------------------------------------------------------

    def generate_initial_design(self):
        assert not self.initialized, "initial design has already been created"
        self.inputs = self.base_design.sample(self.n_init)
        self.current_iteration = self.n_init
        return self.inputs

    def set_initial_targets(self, targets):
        if self.inputs is None:
            raise ValueError("Initial design has not been generated")
        assert self.inputs.shape == (self.n_init, self.get_n_parameters()), (
            "inputs have not been initialized correctly"
        )
        targets = np.atleast_1d(np.squeeze(np.array(targets)))
        assert targets.shape == (self.n_init,), (
            "initial targets must have shape (n_init,)"
        )
        self.targets = np.array(targets)
        self.initialized = True

    def run_initial_design(self):
        assert self.has_function(), (
            "Design must have a bound function to use run_initial_design"
        )
        inputs = self.generate_initial_design()
        targets = np.full((self.n_init,), np.nan)
        for i in range(self.n_init):
            targets[i] = np.array(self.f(inputs[i, :]))
        assert np.all(np.isfinite(targets)), (
            "error in initializing sequential design, function outputs may "
            "not be the correct shape"
        )
        self.set_initial_targets(targets)

    def _generate_candidates(self):
        self.candidates = self.base_design.sample(self.n_cand)

    def _eval_metric(self):
        raise NotImplementedError(
            "Base class for Sequential Design does not implement an "
            "evaluation metric"
        )

    def _estimate_next_target(self, next_point):
        raise NotImplementedError(
            "_estimate_next_target not implemented for base SequentialDesign"
        )

    def get_batch_points(self, n_points):
        """Batch acquisition substituting predicted targets."""
        assert n_points > 0, "n_points must be positive"
        batch_points = np.zeros((n_points, self.get_n_parameters()))
        for i in range(n_points):
            batch_points[i] = self.get_next_point()
            next_target = self._estimate_next_target(batch_points[i])
            self.set_next_target(next_target)
        self.current_iteration = self.current_iteration - n_points
        self.targets = np.array(self.targets[: self.current_iteration])
        return batch_points

    def get_next_point(self):
        if self.inputs is None:
            raise ValueError("Initial design has not been generated")
        assert self.inputs.shape == (
            self.current_iteration,
            self.get_n_parameters(),
        ), "inputs have not been correctly updated"
        if self.targets is None:
            raise ValueError("Initial targets have not been generated")
        assert self.targets.shape == (self.current_iteration,), (
            "targets have not been correctly updated"
        )

        self._generate_candidates()
        next_index = self._eval_metric()

        next_point = self.candidates[next_index, :]
        self.inputs = np.vstack([self.inputs, next_point[None, :]])
        return next_point

    def set_batch_targets(self, new_targets):
        if self.inputs is None:
            raise ValueError("Initial design has not been generated")
        n_points = self.inputs.shape[0] - self.current_iteration
        if self.targets is None:
            raise ValueError("Initial targets have not been generated")
        assert self.targets.shape == (self.current_iteration,), (
            "targets have not been correctly updated"
        )
        new_targets = np.reshape(np.atleast_1d(np.array(new_targets)), (-1,))
        assert new_targets.shape == (n_points,), (
            "new targets must have length n_points"
        )
        self.targets = np.concatenate([self.targets, new_targets])
        self.current_iteration = self.current_iteration + n_points

    def set_next_target(self, target):
        if self.inputs is None:
            raise ValueError("Initial design has not been generated")
        assert self.inputs.shape == (
            self.current_iteration + 1,
            self.get_n_parameters(),
        ), "inputs have not been correctly updated"
        if self.targets is None:
            raise ValueError("Initial targets have not been generated")
        assert self.targets.shape == (self.current_iteration,), (
            "targets have not been correctly updated"
        )
        target = np.reshape(np.atleast_1d(np.array(target)), (-1,))
        assert target.shape == (1,), "new target must have length 1"
        self.targets = np.concatenate([self.targets, target])
        self.current_iteration = self.current_iteration + 1

    def run_next_point(self):
        assert self.has_function(), (
            "Design must have a bound function to use run_next_point"
        )
        next_point = self.get_next_point()
        next_target = np.array(self.f(next_point))
        self.set_next_target(next_target)

    def run_sequential_design(self, n_samples=None):
        assert self.has_function(), (
            "Design must have a bound function to use run_sequential_design"
        )
        if n_samples is None and self.n_samples is None:
            raise ValueError(
                "must specify n_samples either when initializing or calling "
                "run_sequential_design"
            )
        n_iter = self.n_samples if n_samples is None else n_samples
        assert n_iter >= 0, "number of samples must be non-negative"
        self.run_initial_design()
        for _ in range(n_iter):
            self.run_next_point()

    def __str__(self):
        output_string = ""
        output_string += type(self).__name__ + " with\n"
        output_string += self.get_base_design() + " base design\n"
        if self.has_function():
            output_string += "a bound simulator function\n"
        output_string += str(self.get_n_samples()) + " total samples\n"
        output_string += str(self.get_n_init()) + " initial points\n"
        output_string += str(self.get_n_cand()) + " candidate points\n"
        output_string += str(self.get_current_iteration()) + " current samples\n"
        output_string += "current inputs: " + str(self.get_inputs()) + "\n"
        output_string += "current targets: " + str(self.get_targets())
        return output_string


def _loo_variances_all(V, shift=0.0):
    """Leave-one-out variances of every point at once: ``1 / [Q^-1]_ii -
    shift``, clamped at 0.

    ``mogp_tpu`` computes ``v_i = s2 - k_i^T (Q_{-i,-i})^{-1} k_i`` (``k_i =
    C[-i, i]``, ``s2 = cov + nugget``) by blockwise inversion, ``P1 - 2 a_i
    P2 + a_i^2 I_ii - (P2 - a_i I_ii)^2 / I_ii`` from the half-solves ``W =
    L^-1 C`` and ``V = L^-1``.  For ``Q = C + nu I`` that sum is exactly
    ``Q_ii - 1 / I_ii``, so ``v_i = 1 / [Q^-1]_ii - (Q_ii - s2)``: the
    Schur complement of ``Q_{-i,-i}`` in ``Q``, less whatever ``Q``'s
    diagonal carries beyond ``s2`` (the jitter ladder's rung).  Here
    ``I_ii`` is the squared norm of column ``i`` of ``V`` and nothing
    cancels: the blockwise sum subtracts terms of ``cov^2 / nu`` to leave
    ~``nu``, which in float32 at the candidate GP's nugget floor
    (``1e3 eps cov``) loses every digit (``scripts/mice_reference_gap.py``).

    :param V: ``(..., n, n)`` inverse lower factor ``L^-1`` of ``Q``.
    :param shift: ``Q_ii - s2``, broadcast against ``(..., n)``.
    :returns: ``(..., n)``.
    """
    return torch.clamp_min(1.0 / torch.sum(V * V, dim=-2) - shift, 0.0)


class MICEFastGP(GaussianProcess):
    """GP with Woodbury-corrected leave-one-out variance predictions
    (``mogp_tpu/uq/sequential_design.py:332-360``)."""

    @torch.no_grad()
    def fast_predict_all(self):
        """The corrected variance of every index, float64 numpy ``(n,)``:
        :func:`_loo_variances_all` of the fitted factor of ``C + nugget I``
        (one lower solve of the identity)."""
        assert self._artifacts is not None, "MICEFastGP must be fit first"
        L = self._artifacts.Kinv.L
        V = self._artifacts.Kinv.solve_L(torch.eye(self.n, dtype=L.dtype, device=L.device)
                                         .expand_as(L))
        return _loo_variances_all(V)[0].to("cpu", torch.float64).numpy()

    def fast_predict(self, index):
        """Corrected variance for a single excluded index."""
        index = int(index)
        assert 0 <= index < self.n, "index must be 0 <= index < n"
        return float(self.fast_predict_all()[index])


def _device_fault(exc):
    """True for a failure that no refit can cure: the kernels' build or
    launch (``ops/_build.py::KernelError``), or an error of the card."""
    return (isinstance(exc, (KernelError, torch.cuda.OutOfMemoryError))
            or "CUDA error" in str(exc))


class MICEDesign(SequentialDesign):
    """Mutual Information for Computer Experiments sequential design
    (``mogp_tpu/uq/sequential_design.py:363-464``)."""

    def __init__(self, base_design, f=None, n_samples=None, n_init=10,
                 n_cand=50, nugget="adaptive", nugget_s=1.0, device=None, dtype=None):
        if not isinstance(nugget, str):
            try:
                float(nugget)
            except TypeError:
                raise TypeError("nugget must be a string or convertible to a float")
            if nugget < 0.0:
                raise ValueError("nugget parameter cannot be negative")
        if nugget_s < 0.0:
            raise ValueError("nugget smoothing parameter cannot be negative")

        self.nugget = nugget if isinstance(nugget, str) else float(nugget)
        self.nugget_s = float(nugget_s)
        self._t_mean = 0.0
        self._t_std = 1.0
        super().__init__(base_design, f, n_samples, n_init, n_cand, device, dtype)

    def get_nugget(self):
        return self.nugget

    def get_nugget_s(self):
        return self.nugget_s

    def _estimate_next_target(self, next_point):
        next_point = np.array(next_point)
        assert next_point.shape == (self.get_n_parameters(),), (
            "bad shape for next_point"
        )
        # the internal GP is fit on standardized targets
        return self.gp.predict(next_point)[0] * self._t_std + self._t_mean

    def _MICE_criterion(self, data_point):
        """MICE criterion for one candidate."""
        data_point = int(data_point)
        assert 0 <= data_point < self.n_cand, "test point index is out of range"
        _, unc1, _ = self.gp.predict(self.candidates[data_point], unc=True)
        unc2 = self.gp_fast.fast_predict(data_point)
        mice_criter = float(np.asarray(unc1).ravel()[0]) / unc2
        assert np.isfinite(mice_criter), "error in computing MICE criteria"
        return mice_criter

    def _eval_metric(self):
        """Fit the base and candidate GPs and score all candidates at once.

        Up to ten tries, each a fresh MAP fit, on a ``RuntimeError``,
        ``FloatingPointError`` or ``LinAlgError``, as ``mogp_tpu`` does;
        a kernel's build or launch failure, or an error of the card, is
        raised at once (:func:`_device_fault`).
        """
        numtries = 10
        # the internal GP is fit on standardized targets: the criterion is
        # a scale-invariant variance ratio, and standardization keeps the
        # float32 factorizations conditioned on badly scaled simulators
        self._t_mean = float(np.mean(self.targets))
        self._t_std = float(np.std(self.targets)) or 1.0
        targets_std = (self.targets - self._t_mean) / self._t_std
        kw = dict(device=self.device, dtype=self.dtype)
        for i in range(numtries):
            try:
                self.gp = GaussianProcess(self.inputs, targets_std, nugget=self.nugget, **kw)
                self.gp = fit_GP_MAP(self.gp)

                base_nugget = self.gp.theta.nugget
                if base_nugget is None:
                    base_nugget = 0.0
                # the candidate GP's nugget, floored relative to the fitted
                # signal variance: a zero base nugget with long correlation
                # lengths leaves the dense candidate covariance singular
                eps = float(torch.finfo(self.dtype).eps)
                fast_nugget = max(
                    float(base_nugget) * self.nugget_s,
                    1e3 * eps * float(self.gp.theta.cov),
                )
                self.gp_fast = MICEFastGP(
                    self.candidates, np.ones(self.n_cand), nugget=fast_nugget, **kw
                )
                # the correlation and covariance raw parameters of the base fit
                self.gp_fast.fit(
                    np.asarray(self.gp.theta.get_data())[: self.gp_fast.n_params]
                )

                unc1 = self.gp.predict(self.candidates, unc=True)[1]
                unc2 = self.gp_fast.fast_predict_all()
                with np.errstate(divide="ignore", invalid="ignore"):
                    results = unc1 / np.maximum(unc2, 1e-300)
                # degenerate candidates are excluded from the argmax
                results = np.where(np.isfinite(results), results, -np.inf)
                if not np.any(np.isfinite(results)):
                    raise FloatingPointError("non-finite MICE criteria")
                return int(np.argmax(results))
            except (RuntimeError, FloatingPointError, np.linalg.LinAlgError) as exc:
                if _device_fault(exc):
                    raise
                if i == numtries - 1:
                    raise RuntimeError(
                        "Unable to find parameters suitable for both GPs"
                    )
