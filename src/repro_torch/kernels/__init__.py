"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
host-facing wrappers.

* ``congestion`` — interval-congestion sum behind the LP forward operator
                   (``csrc/congestion.cu``).
* ``fit``        — placement feasibility and similarity scoring over all
                   open nodes (``csrc/fit.cu``), batched and single-instance.

``ref`` holds the plain versions, ``ops`` the host-facing API with the
reference's signatures, ``build`` the nvcc build.  ``launch_counts`` reads
each wrapper's launch count and ``reset_launch_counts`` sets them to 0.
"""

from . import ops, ref
from .congestion import congestion_many
from .fit import fit_scores, fit_scores_many

__all__ = ["ops", "ref", "WRAPPERS", "launch_counts", "reset_launch_counts"]

# every kernel wrapper, by kernel name
WRAPPERS = {
    "congestion_many": congestion_many,
    "fit_scores_many": fit_scores_many,
    "fit_scores": fit_scores,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
