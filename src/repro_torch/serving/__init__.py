"""Continuous-batching serving with per-request DMR/TMR on replica slots,
over a dense or paged KV cache."""

from .engine import EngineConfig, EngineParts, ServingEngine, SlotAdapter  # noqa: F401
from .paging import PageTable, infer_paged_axes, mask_slots_paged  # noqa: F401
from .request import (  # noqa: F401
    CANCELLED,
    DONE,
    EXPIRED,
    QUEUED,
    REJECTED,
    RUNNING,
    Request,
    RequestQueue,
)
from .slots import SlotManager, infer_slot_axes, mask_slots  # noqa: F401
