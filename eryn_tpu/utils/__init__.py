"""Utilities (re-design of ``/root/reference/src/eryn/utils/``)."""

from .periodic import PeriodicContainer
from .utility import (
    get_acf,
    get_integrated_act,
    groups_from_inds,
    psrf,
    effective_sample_size,
    rank_normalized_rhat,
    stepping_stone_log_evidence,
    thermodynamic_integration_log_evidence,
)

from scipy.special import logsumexp  # noqa: F401  (re-exported like the ref)

from .plot import PlotContainer
from .profiling import SegmentTimer, trace_profile
from .stopping import AutoCorrelationStop, SearchConvergeStopping, Stopping
from .transform import TransformContainer
from .updates import (
    AdjustStretchProposalScale,
    CompositeUpdate,
    Update,
    UpdateStep,
)

__all__ = [
    "PeriodicContainer",
    "SegmentTimer",
    "trace_profile",
    "logsumexp",
    "groups_from_inds",
    "get_acf",
    "get_integrated_act",
    "thermodynamic_integration_log_evidence",
    "stepping_stone_log_evidence",
    "psrf",
    "effective_sample_size",
    "rank_normalized_rhat",
    "TransformContainer",
    "Stopping",
    "SearchConvergeStopping",
    "AutoCorrelationStop",
    "Update",
    "CompositeUpdate",
    "UpdateStep",
    "AdjustStretchProposalScale",
    "PlotContainer",
]

