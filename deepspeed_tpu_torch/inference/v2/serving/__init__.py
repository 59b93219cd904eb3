"""The SLO-aware serving stack over ``InferenceEngineV2``, from one
frontend to an N-replica cluster (the JAX package's
``inference/v2/serving/``, ported).

Seven modules:

- ``frontend.py`` — ``ServingFrontend``: persistent engine thread driving
  iteration-level continuous batching over ``engine.decode_pipeline``;
  asyncio-facing ``submit() -> token stream``; cancellation at every
  lifecycle stage; cross-replica handoff adoption (``submit_handoff``).
- ``admission.py`` — multi-tenant admission with priority classes: a
  queue-delay + prefill-cost model decides admit / hold / shed per class
  SLO, and plans preemption under KV-pool pressure; its per-class
  queue-delay EMAs are the router's federation signal.
- ``kv_offload.py`` — preempt-by-offload: victims' private KV pages
  round-trip through pinned host buffers (vLLM swap-out, not
  drop-and-recompute), byte-identical on restore; the same bucketed page
  path is the cluster's cross-engine KV fabric.
- ``loadgen.py`` — Poisson open-loop load generator (seed-deterministic,
  shared-prefix mixture components) + goodput-under-SLO scoring.
- ``cluster.py`` — ``ServingCluster``: N data-parallel replicas (uniform
  page fabric, replica-labelled monitor surfaces) + ``PrefillWorker``
  (dedicated SplitFuse prefill under disaggregation).
- ``router.py`` — ``ServingRouter``: cache-aware routing over a shared
  radix-prefix chain index, federated SLO admission, disaggregated
  prefill->decode handoff.
- ``health.py`` — ``HealthMonitor``: replica failure detection (liveness +
  decode-progress stall deadlines), request failover with KV salvage over
  the page fabric, self-healing rejoin with off-hot-path re-warm.

``serve/frontend/*``, ``serve/router/*`` and ``serve/health/*`` counters
(``monitor/serving.py``) and ``serve/req/*``, ``serve/router/*`` and
``serve/health/*`` trace spans (``monitor/trace.py``) make it observable.
"""

from deepspeed_tpu_torch.inference.v2.serving.admission import (AdmissionController,
                                                          CostModel)
from deepspeed_tpu_torch.inference.v2.serving.cluster import (PrefillWorker,
                                                        Replica,
                                                        ServingCluster)
from deepspeed_tpu_torch.inference.v2.serving.frontend import (RequestHandle,
                                                         ServingFrontend)
from deepspeed_tpu_torch.inference.v2.serving.health import (DOWN, DRAINING,
                                                       HEALTHY, REJOINING,
                                                       SUSPECT,
                                                       HealthMonitor)
from deepspeed_tpu_torch.inference.v2.serving.kv_offload import KVOffloadManager
from deepspeed_tpu_torch.inference.v2.serving.loadgen import (Arrival,
                                                        PoissonLoadGen,
                                                        WorkloadComponent,
                                                        goodput_report,
                                                        replay, slo_met)
from deepspeed_tpu_torch.inference.v2.serving.router import (ClusterPrefixIndex,
                                                       ServingRouter)
