"""What one run hands the per-layer metrics' readers."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from harness.trace import Trace


@dataclasses.dataclass
class Run:
    """A run's traced window.

    :param kind "train" or "view"
    :param work operations and bytes of one step or view (the family's `cell_work`)
    :param units steps or views completed in the traced window
    :param trace the traced window's device operations, or None
    :param timed_s host seconds of the untraced window before the traced
        one, ended by a sync
    :param timed_units steps or views completed in it
    :param encode_ms device milliseconds of each traced view's encode,
        by CUDA events around `encode_views`
    """

    kind: str
    work: Dict[str, float]
    units: int
    trace: Optional[Trace]
    timed_s: float = 0.0
    timed_units: int = 0
    encode_ms: List[float] = dataclasses.field(default_factory=list)
