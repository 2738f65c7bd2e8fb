"""Low-latency serving: any fitted pipeline as a web service.

Counterpart of the reference's ``mmlspark_tpu.serving``: a per-host ingress
server feeding a continuous micro-batching loop -- queue -> pad/batch ->
pipeline.transform (fused programs reuse their compile cache) -> reply
routing keyed by request id -- with the pipelined replica executor, the
binary and CSR frame wire, per-tenant admission, the write-ahead journal,
the supervision layer and the routing front. The port-forwarding helper and
the lifecycle, fleet, model-mall and fabric planes wait for ROADMAP A steps
6 and 10.
"""

from .server import ServingServer, reply_to, serve_pipeline
from .routing import RoutingFront, register_worker
from .journal import RequestJournal
from .stages import parse_request, make_reply
from .executor import (AdaptiveBatchController, PipelinedExecutor, Replica,
                       ReplicaSet)
from .aio import AsyncConnectionPool, AsyncHTTPServer
from .tenants import TENANT_HEADER, TenantAdmission, tenants_from_spec
from .supervisor import (BrownoutController, BrownoutStep, DispatchWatchdog,
                         HedgeConfig, HedgeTracker, ReplicaSupervisor)

__all__ = ["AdaptiveBatchController", "AsyncConnectionPool",
           "AsyncHTTPServer", "BrownoutController", "BrownoutStep",
           "DispatchWatchdog", "HedgeConfig", "HedgeTracker",
           "PipelinedExecutor", "Replica", "ReplicaSet", "ReplicaSupervisor",
           "RequestJournal", "RoutingFront", "ServingServer", "TENANT_HEADER",
           "TenantAdmission", "make_reply", "parse_request",
           "register_worker", "reply_to", "serve_pipeline",
           "tenants_from_spec"]
