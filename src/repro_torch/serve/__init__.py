"""Serving: a paged, host-spilling KV-cache pool (`kvpool`), a
continuous-batching request scheduler (`scheduler`), and the engine that
drives the slot-batched decode step (`engine`)."""
from repro_torch.serve.batching import (decode_step_batch, request_prompt_len,
                                        static_batch_from_requests,
                                        synth_prompt_batch, synth_requests)
from repro_torch.serve.engine import ServeEngine, resolve_device
from repro_torch.serve.kvpool import PagedKVPool
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["PagedKVPool", "Request", "Scheduler", "ServeEngine",
           "decode_step_batch", "request_prompt_len", "resolve_device",
           "static_batch_from_requests", "synth_prompt_batch",
           "synth_requests"]
