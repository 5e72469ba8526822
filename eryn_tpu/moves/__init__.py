"""Proposal ("move") zoo (re-design of ``/root/reference/src/eryn/moves/``)."""

from .move import Move, EvalContext
from .red_blue import RedBlueMove
from .stretch import StretchMove
from .tempering import TemperatureControl, make_ladder
from .mh import MHMove
from .gaussian import GaussianMove
from .distgen import DistributionGenerate
from .rj import ReversibleJumpMove
from .distgenrj import DistributionGenerateRJ
from .group import GroupMove
from .groupstretch import GroupStretchMove
from .rbgroupstretch import RedBlueGroupStretchMove
from .combine import CombineMove
from .multipletry import MultipleTryMove, MultipleTryMoveRJ, get_mt_computations
from .mtdistgen import MTDistGenMove
from .mtdistgenrj import MTDistGenMoveRJ
from .delayedrejection import DelayedRejection
from .mala import MALAMove
from .hmc import HMCMove
from .chees import ChEESHMCMove
from .aimh import AIMHMove
from .de import DEMove, DESnookerMove
from .walk import WalkMove
from .kde import KDEMove
from .slice import SliceMove
from .modelswap import BasicSymmetricModelSwapRJMove, ModelSwapRJMove

__all__ = [
    "Move",
    "EvalContext",
    "RedBlueMove",
    "StretchMove",
    "TemperatureControl",
    "make_ladder",
    "MHMove",
    "GaussianMove",
    "DistributionGenerate",
    "ReversibleJumpMove",
    "DistributionGenerateRJ",
    "GroupMove",
    "GroupStretchMove",
    "RedBlueGroupStretchMove",
    "CombineMove",
    "MultipleTryMove",
    "MultipleTryMoveRJ",
    "MTDistGenMove",
    "MTDistGenMoveRJ",
    "get_mt_computations",
    "DelayedRejection",
    "MALAMove",
    "HMCMove",
    "ChEESHMCMove",
    "AIMHMove",
    "DEMove",
    "DESnookerMove",
    "WalkMove",
    "KDEMove",
    "SliceMove",
    "ModelSwapRJMove",
    "BasicSymmetricModelSwapRJMove",
]
