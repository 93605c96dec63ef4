"""Architecture configs (--arch <id>) + assigned shape cells (port of
``repro.configs``; the port keeps its own copies)."""
from repro_torch.configs.registry import ALIASES, ARCH_IDS, ArchConfig, get_config, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeCell, input_specs, skip_reason

__all__ = ["ALIASES", "ARCH_IDS", "ArchConfig", "get_config", "list_archs", "SHAPES",
           "ShapeCell", "input_specs", "skip_reason"]
