"""Rule-based tagging (scene, maneuver, interaction), kernel K3 on the card,
the host-side aggregation (`AutoTagger`), and the vision-language tagger
(BLIP captions -> tags)."""

from .auto_tagger import AutoTagger
from .rules import (
    CONDITIONS,
    INTERACTIONS,
    LATERAL,
    LONGITUDINAL,
    RISKS,
    ROAD_TYPES,
    TURNING,
    make_tagging_step,
)
from .vlm import VLMTagger, VLMTags

__all__ = [
    "AutoTagger",
    "make_tagging_step",
    "ROAD_TYPES",
    "LATERAL",
    "LONGITUDINAL",
    "TURNING",
    "INTERACTIONS",
    "RISKS",
    "CONDITIONS",
    "VLMTagger",
    "VLMTags",
]
