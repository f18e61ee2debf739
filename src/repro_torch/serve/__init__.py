"""Serving layers of the port.

LLM serving (prefill + single-token decode) for the dense family: see
``llm_decode``.  Online placement serving: bounded request queue,
micro-batched decision step over the replay's runners, admission
governor with graceful degradation, and checkpoint/restore (see
``placement``)."""
from .placement import (Decision, Governor, ILP_TIER, PlacementService,
                        ServeConfig, requests_from_trace)
from .queue import (Arrival, BoundedRequestQueue, Departure, Request,
                    arrival_bucket, departure_bucket)

__all__ = ["PlacementService", "ServeConfig", "Decision", "Governor",
           "ILP_TIER", "requests_from_trace", "Arrival", "Departure",
           "Request", "BoundedRequestQueue", "arrival_bucket",
           "departure_bucket"]
