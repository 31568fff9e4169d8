"""Batched multi-simulation serving (the JAX package's ``serving``).

A fixed-capacity slot pool holds B independent simulations batched along a
leading ensemble axis (`models._batched`); one batched step advances every
active member per round (one launch of the model's CUDA kernel per group
and one exchange per dimension for all B), and a request queue admits and
retires members mid-flight: per-member step budgets, per-member
convergence (the porous PT residual), and per-member guards (a NaN in
member k evicts or rolls back member k, never the batch).

`FrontDoor` is the HTTP entry (``POST /v1/submit`` → `AdmissionController`:
per-tenant token-bucket quotas, queue/SLO backpressure, cheap 429s with a
cadence-derived ``Retry-After``), and `Autoscaler` grows and shrinks the
topology under load through checkpoint + supervised restart + elastic
resume.

Public surface: `Request`, `MemberResult`, `ServingLoop` (`serving.loop`);
`FrontDoor`, `RESIZE_STATUS` (`serving.frontdoor`); `AdmissionController`,
`AdmissionPolicy` (`serving.admission`); `Autoscaler`, `AutoscalePolicy`,
`Rung` (`serving.autoscale`).  The knobs (``IGG_BATCH``,
``IGG_BATCH_ROUND_STEPS``, ``IGG_SERVE_PORT``, ``IGG_TENANT_QUOTA``, ...)
are `utils.config`'s.
"""

from .admission import AdmissionController, AdmissionPolicy
from .autoscale import AutoscalePolicy, Autoscaler, Rung
from .frontdoor import RESIZE_STATUS, FrontDoor
from .loop import MemberResult, Request, ServingLoop

__all__ = [
    "Request",
    "MemberResult",
    "ServingLoop",
    "FrontDoor",
    "RESIZE_STATUS",
    "AdmissionController",
    "AdmissionPolicy",
    "Autoscaler",
    "AutoscalePolicy",
    "Rung",
]
