"""Command plane: HTTP command center + heartbeat (reference
``sentinel-transport/*`` rebuilt on the stdlib http server).

The PyTorch port's own copy of ``sentinel_tpu/transport/__init__.py``.
"""

from sentinel_tpu_torch.transport.command import (  # noqa: F401
    CommandCenter, CommandRequest, CommandResponse, command_mapping,
)
from sentinel_tpu_torch.transport.handlers import register_default_handlers  # noqa: F401
from sentinel_tpu_torch.transport.http_server import SimpleHttpCommandCenter  # noqa: F401
from sentinel_tpu_torch.transport.heartbeat import HeartbeatSender  # noqa: F401
from sentinel_tpu_torch.transport.bootstrap import (  # noqa: F401
    TransportRuntime, start_transport,
)
from sentinel_tpu_torch.transport.mounted import (  # noqa: F401
    command_asgi_app, command_wsgi_app,
)
