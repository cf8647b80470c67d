"""Serving: the step-builder cache and ``generate`` (``engine``), the
slot scheduler (``scheduler``) and the seeded traffic replay
(``traffic``) — what the reference's ``repro.serving`` exports."""
from repro_torch.serving.engine import (build_decode, build_prefill,
                                        build_slot_prefill, clear_step_cache,
                                        generate, make_prefill_step,
                                        make_serve_step, serve_config,
                                        validate_decode_config)
from repro_torch.serving.scheduler import Request, SlotServer
from repro_torch.serving.traffic import (TrafficConfig, TrafficReport, replay,
                                         skew_router, synthesize_workload)
