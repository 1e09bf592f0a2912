"""Dynamic rule datasources (reference ``sentinel-datasource-extension``):
readable sources feed rule properties; writable sources persist dashboard
pushes (SURVEY §2.2, L5).

The PyTorch port's own copy of ``sentinel_tpu/datasource/__init__.py``.
"""

from sentinel_tpu_torch.datasource.base import (  # noqa: F401
    AbstractDataSource, AutoRefreshDataSource, FileRefreshableDataSource,
    FileWritableDataSource, ReadableDataSource, WritableDataSource,
)
from sentinel_tpu_torch.datasource.registry import (  # noqa: F401
    WritableDataSourceRegistry, default_registry,
)
from sentinel_tpu_torch.datasource.converters import rule_converter, rule_encoder  # noqa: F401
from sentinel_tpu_torch.datasource.http import (  # noqa: F401
    HttpLongPollDataSource, HttpRefreshableDataSource, InProcessDataSource,
)
from sentinel_tpu_torch.datasource.named import (  # noqa: F401
    ApolloDataSource, ConsulDataSource, EtcdDataSource, EurekaDataSource,
    NacosDataSource, RedisDataSource, SpringCloudConfigDataSource,
    ZooKeeperDataSource,
)
