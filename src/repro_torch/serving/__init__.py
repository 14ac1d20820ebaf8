from repro_torch.serving.engine import (
    DEFAULT_MEGASTEP_K, PHASE_DECODE, PHASE_IDLE, PHASE_PREFILL,
    EngineStats, PromptTooLong, Request, ServingEngine, SlotState)
from repro_torch.serving.sampler import SamplingConfig, sample, sample_batched

__all__ = ["ServingEngine", "Request", "EngineStats", "SlotState",
           "SamplingConfig", "sample", "sample_batched",
           "DEFAULT_MEGASTEP_K", "PHASE_IDLE", "PHASE_PREFILL",
           "PHASE_DECODE", "PromptTooLong"]
