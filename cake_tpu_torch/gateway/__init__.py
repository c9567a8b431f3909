"""Multi-replica routing gateway in front of the serve plane.

``--mode serve`` scales one process; this package scales horizontally: a
stdlib-only HTTP front door (``--mode gateway --backends h:p,h:p,...``)
that health-checks a fleet of serve replicas (``gateway/health.py``:
UP / DRAINING / DOWN with probe hysteresis and a circuit breaker on the
``runtime/retry`` backoff shape), routes each request by a pluggable
policy (``gateway/policy.py``: power-of-two-choices on the live load
signal, round-robin, or prefix affinity that turns the per-engine prefix
KV store into a fleet-wide cache), and proxies unary + SSE responses
byte-for-byte with transparent retry before the first forwarded byte
(``gateway/api.py``).

A port of ``cake_tpu/gateway``: framework-free Python that imports no
``torch`` (a gateway holds no model and opens no CUDA context), so its
policies make the JAX gateway's choices on the same inputs.
"""

from cake_tpu_torch.gateway.api import (GatewayServer, parse_backends,
                                  start_gateway)
from cake_tpu_torch.gateway.health import (DOWN, DRAINING, UP, Backend,
                                     HealthMonitor)
from cake_tpu_torch.gateway.policy import POLICIES, make_policy, prefix_key

__all__ = [
    "Backend",
    "DOWN",
    "DRAINING",
    "GatewayServer",
    "HealthMonitor",
    "POLICIES",
    "UP",
    "make_policy",
    "parse_backends",
    "prefix_key",
    "start_gateway",
]
