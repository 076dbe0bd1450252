"""Serving of the port (counterpart of ``paddle_tpu/serving``): the LoRA
adapter registry, and the engine's request type and sampling key. The
control plane (scheduler, router, frontend, handoff transport) comes in a
later slice (ROADMAP.md)."""
from .adapters import AdapterRegistry, LoRAAdapter
from ..inference.continuous import EngineRequest, canonical_sampling

__all__ = ["AdapterRegistry", "LoRAAdapter", "EngineRequest",
           "canonical_sampling"]
