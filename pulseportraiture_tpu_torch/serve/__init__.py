"""The continuous-batching TOA service (counterpart of
pulseportraiture_tpu/serve/).

One warm stream executor per process, fed by a bounded admission queue:
concurrent clients submit archives, compatible subints coalesce into
shared dispatches across requests (a bucket launches when full or past
``config.serve_max_wait_ms``), and completed TOAs demultiplex back to
per-request ``.tim`` results byte-identical to the one-shot stream's.
See serve/server.py; the CLI is ``python -m
pulseportraiture_tpu_torch.cli.ppserve -r requests.jsonl``.

``cache.py`` keys completed ``.tim`` results by SHA-256 over (archive
bytes, template bytes, frozen options, numeric knobs), the JAX
package's key, in a bounded on-disk LRU; off by default
(``config.result_cache='auto'`` engages only with ``config.cache_dir``).
The same store keeps ``ppfactory``'s built templates as blobs.

Across processes and hosts: ``transport.py`` puts the client surface
behind the JAX package's length-prefixed JSON protocol
(``TransportServer`` under ``ppserve --listen``, ``SocketTransport``;
``InProcTransport`` for a server in this process), ``fleet.py`` keeps
the membership and each host's health state machine, and
``router.ToaRouter`` (``python -m pulseportraiture_tpu_torch.cli.pproute``)
shards a campaign's requests over the fleet: least-loaded placement with
per-template affinity, backpressure retries, exactly-once failover,
hedged requests, the codec lane and refit-aware routing, each request's
``.tim`` byte-identical to the one-shot's whichever host served it.
"""

from .cache import ResultCache, content_key, resolve_result_cache  # noqa: F401
from .client import ToaClient, collect_results  # noqa: F401
from .codec import (copy_tim_atomic, decode_result,  # noqa: F401
                    encode_result, read_tim_result, roundtrip_result,
                    tim_complete, write_tim_result)
from .fleet import (DEAD, HEALTHY, JOINING, REJOINED,  # noqa: F401
                    SUSPECT, Fleet, FleetFileWatcher, FleetMember)
from .queue import AdmissionQueue, ServeRejected, ServeRequest  # noqa: F401
from .router import RouteHandle, ToaRouter  # noqa: F401
from .server import ToaServer  # noqa: F401
from .transport import (InProcTransport, KillableTransport,  # noqa: F401
                        RemoteRequestError, SocketTransport,
                        TransportError, TransportServer)
