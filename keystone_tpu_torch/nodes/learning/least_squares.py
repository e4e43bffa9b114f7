"""Solver-selecting least squares (counterpart of
keystone_tpu/nodes/learning/least_squares.py).

``choose_solver`` is the reference's cost model (:42-73) with its
thresholds and reason strings: ``local`` when the float32 data is under 16
MiB and ``d ≤ 2048``; ``normal`` when the (d, d) gram and two (d, k)
arrays fit an eighth of the device's memory and ``d ≤ 32768``; ``block``
otherwise. The budget is ``utils/metrics.py::device_hbm_bytes`` of the
device named (the card's total memory; on the CPU the configured budget)
unless ``hbm_budget_bytes`` is given. ``LeastSquaresEstimator`` maps each
choice onto the port's ``LocalLeastSquaresEstimator``,
``LinearMapEstimator`` and ``BlockLeastSquaresEstimator``.

``partial_fit`` and ``solve_online`` belong to the reference's online
trainer (``workflow/online.py``), which is not ported: they raise.
"""

from __future__ import annotations

from dataclasses import dataclass

from keystone_tpu_torch.config import as_input
from keystone_tpu_torch.nodes.learning.block_least_squares import BlockLeastSquaresEstimator
from keystone_tpu_torch.nodes.learning.linear_mapper import LinearMapEstimator
from keystone_tpu_torch.nodes.learning.local_least_squares import LocalLeastSquaresEstimator
from keystone_tpu_torch.utils.metrics import device_hbm_bytes
from keystone_tpu_torch.workflow import LabelEstimator, Transformer


@dataclass
class SolverChoice:
    name: str  # "local" | "normal" | "block"
    reason: str


def choose_solver(n: int, d: int, k: int, hbm_budget_bytes: int | None = None,
                  block_size: int = 4096, device=None) -> SolverChoice:
    hbm = hbm_budget_bytes if hbm_budget_bytes else device_hbm_bytes(device)
    bytes_per = 4  # f32
    if n * d * bytes_per < 1 << 24 and d <= 2048:
        return SolverChoice("local", f"tiny problem (n={n}, d={d})")
    # Normal equations materialize the (d, d) gram plus the (d, k) solution
    # and right-hand side; all must sit in device memory beside the data.
    dense_bytes = (d * d + 2 * d * k) * bytes_per
    if dense_bytes <= hbm // 8 and d <= 32768:
        return SolverChoice("normal", f"gram+solution fit HBM ({dense_bytes >> 20} MiB)")
    return SolverChoice(
        "block",
        f"(d={d}, k={k}) too large for a dense gram; streaming {block_size}-col blocks",
    )


class LeastSquaresEstimator(LabelEstimator):
    """Picks the concrete solver by cost model at fit time, and fits on the
    device of a tensor it is given; host arrays go to ``device`` (``cuda``
    unless named). ``num_iters`` and ``block_size`` apply only to the block
    solver."""

    # Set by each dispatch: an outcome, not a hyperparameter of the fit.
    _signature_exclude = ("last_choice",)

    def __init__(self, lam: float = 0.0, block_size: int = 4096, num_iters: int = 3,
                 hbm_budget_bytes: int | None = None, device=None):
        self.lam = lam
        self.block_size = block_size
        self.num_iters = num_iters
        self.hbm_budget_bytes = hbm_budget_bytes
        self.device = device
        self.last_choice: SolverChoice | None = None

    def optimize_node(self, data_shape, labels_shape=None):
        """The concrete solver for the dataset's shapes, for a graph
        optimizer's node rule; self when the shapes do not say enough
        (fit-time dispatch then still applies)."""
        if len(data_shape) != 2:
            return self
        n, d = int(data_shape[0]), int(data_shape[1])
        if labels_shape is None:
            return self
        k = int(labels_shape[1]) if len(labels_shape) > 1 else 1
        choice = choose_solver(n, d, k, self.hbm_budget_bytes, self.block_size, self.device)
        self.last_choice = choice
        return self._concrete(choice)

    def _concrete(self, choice: SolverChoice) -> LabelEstimator:
        """The one mapping from a choice to its estimator, shared by
        ``optimize_node`` and ``fit``."""
        if choice.name == "local":
            return LocalLeastSquaresEstimator(self.lam, device=self.device)
        if choice.name == "normal":
            return LinearMapEstimator(self.lam, device=self.device)
        if choice.name == "block":
            return BlockLeastSquaresEstimator(
                block_size=self.block_size, num_iters=self.num_iters, lam=self.lam,
                device=self.device,
            )
        raise ValueError(f"unknown solver choice {choice.name!r}")

    def partial_fit(self, data, labels, state=None, decay=None, window=None, chunk_rows=None):
        raise NotImplementedError(
            "partial_fit comes with the online trainer (workflow/online.py), ROADMAP Queue 1 item 4"
        )

    def solve_online(self, state):
        raise NotImplementedError(
            "solve_online comes with the online trainer (workflow/online.py), ROADMAP Queue 1 item 4"
        )

    def fit(self, data, labels) -> Transformer:
        X = as_input(data, self.device)
        Y = as_input(labels, X.device).to(X.device)
        n, d = X.shape
        k = Y.shape[1] if Y.ndim > 1 else 1
        choice = choose_solver(n, d, k, self.hbm_budget_bytes, self.block_size, X.device)
        self.last_choice = choice
        return self._concrete(choice).fit(X, Y)
