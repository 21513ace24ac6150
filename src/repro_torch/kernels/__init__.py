"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
host-facing wrappers.

* ``congestion`` — interval-congestion sum behind the LP forward operator
                   (``csrc/congestion.cu``).
* ``fit``        — placement feasibility and similarity scoring over all
                   open nodes (``csrc/fit.cu``), batched and single-instance.
* ``place_step`` — the placement steppers (``csrc/place_step.cu``): every
                   step of one placement sub-phase in one launch (the
                   compiled fleet path), and one instance's whole
                   ``two_phase`` in one launch (``two_phase_walk``).
* ``wkv``        — the RWKV-6 recurrence, forward and backward
                   (``csrc/wkv.cu``), as the ``repro_torch::wkv`` operator.
* ``scan``       — the RG-LRU linear scan, forward and backward
                   (``csrc/scan.cu``), as ``repro_torch::linear_scan``.
* ``lane_sum``   — the LP's sums over one lane's elements, in an order that
                   does not depend on the batch (``csrc/lane_sum.cu``).

``ref`` holds the plain versions, ``ops`` the host-facing API with the
reference's signatures, ``build`` the nvcc build.  ``launch_counts`` reads
each wrapper's launch count and ``reset_launch_counts`` sets them to 0
(and the congestion kernel's per-card counts, ``congestion.launches_by_card``).
A CUDA graph's capture records launches and runs none: ``launch_marks`` and
``rewind_launches`` take a capture's launches back out of the counts, and
``add_launches`` adds them for each replay.
"""

from . import congestion, lane_sum, ops, ref
from .congestion import congestion_many
from .fit import fit_scores, fit_scores_many
from .place_step import sub_phase, two_phase_walk
from .scan import scan_backward, scan_forward
from .wkv import wkv_backward_launch, wkv_forward

__all__ = ["ops", "ref", "WRAPPERS", "launch_counts", "reset_launch_counts",
           "launch_marks", "rewind_launches", "add_launches"]

# every kernel wrapper, by kernel name
WRAPPERS = {
    "congestion_many": congestion_many,
    "fit_scores_many": fit_scores_many,
    "fit_scores": fit_scores,
    "place_step": sub_phase,
    "two_phase": two_phase_walk,
    "wkv": wkv_forward,
    "wkv_backward": wkv_backward_launch,
    "linear_scan": scan_forward,
    "linear_scan_backward": scan_backward,
    "lane_sum": lane_sum.lane_sum,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    congestion._BY_CARD.clear()


def launch_marks() -> tuple[dict[str, int], dict[int, int]]:
    """Every launch count now, and the congestion kernel's per card."""
    return launch_counts(), congestion.launches_by_card()


def rewind_launches(marks) -> tuple[dict[str, int], dict[int, int]]:
    """Sets every count back to ``marks`` (``launch_marks``) and returns
    the launches counted since, as ``add_launches`` takes them."""
    counts, by_card = marks
    now, now_card = launch_marks()
    for name, fn in WRAPPERS.items():
        fn.launches = counts[name]
    congestion._BY_CARD.clear()
    congestion._BY_CARD.update(by_card)
    return ({k: v - counts[k] for k, v in now.items() if v != counts[k]},
            {d: v - by_card.get(d, 0) for d, v in now_card.items()
             if v != by_card.get(d, 0)})


def add_launches(added) -> None:
    """Adds ``rewind_launches``' launches to the counts."""
    counts, by_card = added
    for name, n in counts.items():
        WRAPPERS[name].launches += n
    congestion._BY_CARD.update(by_card)
