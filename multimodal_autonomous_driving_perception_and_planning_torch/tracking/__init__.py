"""Multi-object tracking."""

from .tracker import confirmed_mask, id_rank, tracker_update

__all__ = ["tracker_update", "confirmed_mask", "id_rank"]
